"""Rule family 5: a repo AST lint for the device wave path, in torch terms.

Counterpart of ``repro/analysis/astlint.py``.  Its five rules:

* ``no-bare-assert``: ``assert`` is stripped under ``python -O``; the
  wave path raises structured errors (``QueueOverflowError`` /
  ``ServeInvariantError``) instead.
* ``no-host-sync-in-wave``: ``int()``, ``float()`` or ``bool()`` of a
  tensor expression, ``.item()`` or ``.tolist()`` inside *device scope*
  (the reference's ``no-traced-cast``).  A tensor read on the host waits
  for the device stream: one sync per wave where the port promises none
  (``dqueue/wave_engine.py``: "No wave reads a device value on the
  host").  As the reference lets ``int()`` of host values pass, a cast of
  a value that is known on the host passes: a constant, ``len(...)``, a
  ``.shape``/``.ndim`` read, ``.size()``/``.numel()``/``.dim()``, or
  arithmetic of those.
* ``no-sync-in-burst``: ``torch.cuda.synchronize()`` (any
  ``.synchronize()``) or ``.item()`` inside a ``for``/``while`` loop of
  a burst method (``run_waves``, ``_multi_sequential``,
  ``_multi_pipelined``): it serialises the waves the burst overlaps
  (the reference's ``no-block-in-burst``).
* ``no-host-callback-in-wave``: ``print``, ``.cpu()`` or ``.numpy()`` in
  device scope; the Wavescope drain (``drain``, ``drain_metrics``,
  ``_drain_telemetry``) is the one sanctioned host read and is exempt.
* ``no-direct-device``: ``torch.device("cuda...")``, ``.cuda()``,
  ``torch.cuda.set_device`` or ``torch.cuda.device_count()`` in
  ``dqueue/``, ``serve/``, ``fault/`` or ``obs/``: the runtime seam
  (``runtime/``) owns the device, as the reference's ``no-direct-mesh``
  has its mesh owned by ``repro.runtime``.  Not in
  :data:`DEFAULT_RULES`; :func:`lint_paths` applies it over
  :data:`DEVICE_SCOPE_MODULES`.

Device scope: the methods of the reference's ``_DEVICE_METHODS`` that the
port's discipline and wave-engine classes define (a class named
``WaveEngine`` or ``*Discipline``) and the seed wave
``DeviceQueue._legacy_wave``, the functions nested in them, and
what they call: module-level functions and wave-class methods of the
linted modules, by name, to a fixed point (the wave runs them; the
reference roots the functions it hands to jit, scan and shard_map the
same way).
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Sequence, Set, Tuple

from .report import Violation

# Discipline / WaveEngine methods that run inside the wave
# (the reference's _DEVICE_METHODS)
_DEVICE_METHODS = frozenset({
    "split", "merge", "dispatch", "commit", "zero_outs", "zero_aux",
    "_wave", "_multi_sequential", "_multi_pipelined", "_pack_request",
    "_extract_reply", "_out_specs", "_metric_row", "occupancy",
})
# the seed wave: a device method of the structure class itself (the
# reference roots it by its jit)
_SEED_WAVE = "_legacy_wave"
_BURST_METHODS = frozenset({"run_waves", "_multi_sequential",
                            "_multi_pipelined"})
_CASTS = frozenset({"int", "float", "bool"})
_SYNC_METHODS = frozenset({"item", "tolist"})
# print(...), and the methods .cpu() and .numpy()
_HOST_CALLBACKS = frozenset({"print", "cpu", "numpy"})
# the sanctioned Wavescope drain: the ONE device->host telemetry read
_OBS_DRAIN_API = frozenset({"drain", "drain_metrics", "_drain_telemetry"})
# host-known values a cast may read without a sync
_HOST_ATTRS = frozenset({"shape", "ndim"})
_HOST_METHODS = frozenset({"size", "numel", "dim"})

DEFAULT_MODULES = (
    "src/repro_torch/dqueue",
    "src/repro_torch/core/scan_queue.py",
    "src/repro_torch/serve/engine.py",
)

DEFAULT_RULES = frozenset({
    "no-bare-assert", "no-host-sync-in-wave", "no-sync-in-burst",
    "no-host-callback-in-wave",
})

# where no-direct-device applies: every layer above the runtime seam
DEVICE_SCOPE_MODULES = (
    "src/repro_torch/dqueue",
    "src/repro_torch/serve",
    "src/repro_torch/fault",
    "src/repro_torch/obs",
)


def _callee_tail(func: ast.expr) -> str:
    """'torch.cuda.synchronize' -> 'synchronize', 'int' -> 'int'."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _dotted(func: ast.expr) -> str:
    parts = []
    while isinstance(func, ast.Attribute):
        parts.append(func.attr)
        func = func.value
    if isinstance(func, ast.Name):
        parts.append(func.id)
    return ".".join(reversed(parts))


def _host_known(e: ast.expr) -> bool:
    """True for an expression whose value the host holds without reading
    the device: a constant, ``len(...)``, a shape read, arithmetic of
    those."""
    if isinstance(e, ast.Constant):
        return True
    if isinstance(e, ast.Attribute) and e.attr in _HOST_ATTRS:
        return True
    if isinstance(e, ast.Subscript):
        return _host_known(e.value)
    if isinstance(e, ast.Call):
        tail = _callee_tail(e.func)
        if isinstance(e.func, ast.Name) and tail == "len":
            return True
        return isinstance(e.func, ast.Attribute) and tail in _HOST_METHODS
    if isinstance(e, ast.BinOp):
        return _host_known(e.left) and _host_known(e.right)
    if isinstance(e, ast.UnaryOp):
        return _host_known(e.operand)
    return False


class _DeviceScopeFinder:
    """Device-scope roots of one module: the wave methods of its discipline
    and engine classes, the functions and wave-class methods named in
    ``extra`` (called from device scope in another module), then the
    module functions and same-class methods these call, to a fixed
    point.  ``called`` holds every name a rooted function calls (a plain
    name or a ``self.`` method)."""

    def __init__(self, tree: ast.Module, extra: Set[str] = frozenset()):
        self.module_fns: Dict[str, ast.AST] = {}
        self.methods: Dict[Tuple[str, str], ast.AST] = {}
        self.rooted: Set[Tuple[str, str]] = set()   # (class or "", name)
        self.called: Set[str] = set()
        for st in tree.body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.module_fns[st.name] = st
                if st.name in extra:
                    self.rooted.add(("", st.name))
            elif isinstance(st, ast.ClassDef):
                wave_cls = (st.name == "WaveEngine"
                            or st.name.endswith("Discipline"))
                for m in st.body:
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                        self.methods[(st.name, m.name)] = m
                        if m.name == _SEED_WAVE or wave_cls and (
                                m.name in _DEVICE_METHODS
                                or m.name in extra):
                            self.rooted.add((st.name, m.name))
        todo = list(self.rooted)
        while todo:
            cls, name = todo.pop()
            fn = (self.methods.get((cls, name)) if cls
                  else self.module_fns.get(name))
            for call in (n for n in ast.walk(fn) if isinstance(n, ast.Call)):
                f = call.func
                key = None
                if isinstance(f, ast.Name):
                    self.called.add(f.id)
                    if f.id in self.module_fns:
                        key = ("", f.id)
                elif isinstance(f, ast.Attribute) and isinstance(
                        f.value, ast.Name) and f.value.id == "self":
                    self.called.add(f.attr)
                    if cls and (cls, f.attr) in self.methods:
                        key = (cls, f.attr)
                if key and key not in self.rooted:
                    self.rooted.add(key)
                    todo.append(key)


class _ModuleLinter(ast.NodeVisitor):
    def __init__(self, path: str, tree: ast.Module,
                 rules: "Iterable[str] | None" = None,
                 extra: Set[str] = frozenset()) -> None:
        self.path = path
        self.rules = frozenset(DEFAULT_RULES if rules is None else rules)
        self.violations: List[Violation] = []
        self._rooted = _DeviceScopeFinder(tree, extra).rooted
        self._cls: List[str] = []
        # (name, is_device, is_burst)
        self._scope: List[Tuple[str, bool, bool]] = []
        self._loops: List[int] = [0]

    # ------------------------------------------------------ scope track ---
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._cls.append(node.name)
        self.generic_visit(node)
        self._cls.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        parent = self._scope[-1] if self._scope else ("", False, False)
        cls = self._cls[-1] if self._cls and not self._scope else ""
        device = parent[1] or (cls, node.name) in self._rooted
        burst = parent[2] or node.name in _BURST_METHODS
        self._scope.append((node.name, device, burst))
        self._loops.append(0)
        self.generic_visit(node)
        self._loops.pop()
        self._scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def _in_device_scope(self) -> bool:
        return bool(self._scope) and self._scope[-1][1]

    def _fn(self) -> str:
        return ".".join(n for n, _, _ in self._scope)

    def _flag(self, node, check: str, msg: str, **detail) -> None:
        self.violations.append(Violation(
            "repo_ast", f"{self.path}:{node.lineno}", msg,
            {"check": check, "line": node.lineno, **detail}))

    # ------------------------------------------------------------ rules ---
    def visit_Assert(self, node: ast.Assert) -> None:
        if "no-bare-assert" in self.rules:
            self._flag(node, "no-bare-assert",
                       "bare assert in a device-path module — raise a "
                       "structured error (QueueOverflowError / "
                       "ServeInvariantError) instead")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        tail = _callee_tail(node.func)
        dotted = _dotted(node.func)
        method = isinstance(node.func, ast.Attribute)
        if "no-direct-device" in self.rules:
            cuda_dev = (dotted == "torch.device" and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and str(node.args[0].value).startswith("cuda"))
            if cuda_dev or (method and tail == "cuda" and not node.args) \
                    or dotted in ("torch.cuda.set_device",
                                  "torch.cuda.device_count"):
                self._flag(node, "no-direct-device",
                           f"direct device call '{dotted or tail}(...)' "
                           "above the runtime seam — the device is owned "
                           "by the runtime (repro_torch.runtime, "
                           "Runtime.device)", callee=dotted or tail)
        device = self._in_device_scope()
        if "no-host-sync-in-wave" in self.rules and device:
            cast = (isinstance(node.func, ast.Name) and tail in _CASTS
                    and node.args and not _host_known(node.args[0]))
            if cast or (method and tail in _SYNC_METHODS):
                self._flag(node, "no-host-sync-in-wave",
                           f"{tail}() on a tensor inside device scope "
                           f"'{self._fn()}' — reads the device on the host "
                           f"(a sync per wave)", scope=self._fn())
        if "no-host-callback-in-wave" in self.rules and device \
                and self._scope[-1][0] not in _OBS_DRAIN_API \
                and tail in _HOST_CALLBACKS and method == (tail != "print"):
            self._flag(node, "no-host-callback-in-wave",
                       f"host callback '{tail}' inside device scope "
                       f"'{self._fn()}' — an unbudgeted device->host copy "
                       "per wave; telemetry rides the Wavescope metrics "
                       "ring and drains at burst boundaries",
                       scope=self._fn())
        if "no-sync-in-burst" in self.rules and self._loops[-1] > 0 \
                and self._scope and self._scope[-1][2] and method \
                and tail in ("synchronize", "item"):
            self._flag(node, "no-sync-in-burst",
                       f".{tail}() inside a burst loop serialises the "
                       "waves the burst overlaps — hoist it after the loop")
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        self._loops[-1] += 1
        self.generic_visit(node)
        self._loops[-1] -= 1

    visit_While = visit_For  # type: ignore[assignment]


def lint_source(src: str, path: str = "<string>",
                rules: "Iterable[str] | None" = None,
                extra: Set[str] = frozenset()) -> List[Violation]:
    """Lint one module's source with ``rules`` (default
    :data:`DEFAULT_RULES`); ``extra`` names functions and wave-class
    methods that other modules call from device scope."""
    tree = ast.parse(src)
    linter = _ModuleLinter(path, tree, rules=rules, extra=extra)
    linter.visit(tree)
    return linter.violations


def _expand(root: str, modules: Sequence[str]) -> List[str]:
    out: List[str] = []
    for m in modules:
        p = os.path.join(root, m)
        if os.path.isdir(p):
            out.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if f.endswith(".py")))
        elif os.path.isfile(p):
            out.append(p)
    return out


def _repo_root() -> str:
    # .../src/repro_torch/analysis/astlint.py -> the repo root, 3 above src
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.abspath(os.path.join(here, "..", "..", ".."))


def lint_paths(modules: Sequence[str] = DEFAULT_MODULES,
               root: "str | None" = None
               ) -> "tuple[List[Violation], Dict[str, object]]":
    """Lint the wave-path modules: files under ``modules`` get
    :data:`DEFAULT_RULES`, files under :data:`DEVICE_SCOPE_MODULES` also
    ``no-direct-device`` (rule sets union where the scopes overlap)."""
    root = root or _repo_root()
    per_file: Dict[str, Set[str]] = {}
    for f in _expand(root, modules):
        per_file.setdefault(f, set()).update(DEFAULT_RULES)
    for f in _expand(root, DEVICE_SCOPE_MODULES):
        per_file.setdefault(f, set()).add("no-direct-device")
    trees = {}
    for f in sorted(per_file):
        with open(f, "r", encoding="utf-8") as fh:
            trees[f] = ast.parse(fh.read())
    # names called from device scope anywhere are device scope where
    # they are defined (ring_commit, gather_ops, the scans), to a fixed
    # point over the modules
    extra: Set[str] = set()
    while True:
        called = set().union(*(_DeviceScopeFinder(t, extra).called
                               for t in trees.values()))
        if called <= extra:
            break
        extra |= called
    violations: List[Violation] = []
    for f, tree in trees.items():
        linter = _ModuleLinter(os.path.relpath(f, root), tree,
                               rules=per_file[f], extra=extra)
        linter.visit(tree)
        violations.extend(linter.violations)
    return violations, {"files_checked": [os.path.relpath(f, root)
                                          for f in sorted(per_file)]}
