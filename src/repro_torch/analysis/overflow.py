"""Rule family 4: the int32-overflow lint over the tropical-semiring graphs.

Counterpart of ``repro/analysis/overflow.py``, over aten graphs traced by
``torch.fx.experimental.proxy_tensor.make_fx`` in place of jaxprs.  The
scan-queue arithmetic lives on int32 with ``INF = 2**30`` as tropical
+infinity, and the Seap directory carries full-range keys
(``key_lo``/``key_hi`` start at +-2^31).  What keeps it sound is
structural: every add/sub touching an extreme value is clamped
(``minimum``/``maximum``/``clamp*``/``amin``/``amax``) or selected
around (``where``), or is the reference's blessed overflow-free
midpoint ``(a & b) + ((a ^ b) >> 1)``.  (The reference's other blessed
idiom, ``associative_scan``'s interleave of two interior-padded arrays,
has no aten form: aten has no interior padding, and the port's scans
are Hillis-Steele over slices and ``cat``.)

A forward taint pass marks values reachable from extreme constants
(``|v| >= 2^30``: a literal argument, a ``scalar_tensor``/``full`` fill,
a tensor constant) or from the arguments named tainted, and reports:

  V1 ``both-extreme-add``: add/sub/mul with *both* operands tainted
     (wraps regardless of downstream guards);
  V2 ``unclamped-extreme-add``: add/sub/mul with one tainted operand
     whose result reaches no guard (through ops that only move values)
     within 8 steps, or leaves the graph first.

A literal argument of an op that only moves values (a slice's end, a
view's shape, a pad's widths) is an index, not a value, and taints
nothing: the jaxpr keeps those in equation parameters.  The two such
literals that become array data, a pad's fill and a scatter's scalar,
taint as any other (the jaxpr's pad and scatter take them as operands).
"""
from __future__ import annotations

import operator
from typing import Any, Dict, List, Sequence, Tuple

import torch

from .report import Violation

TAINT_BOUND = 2 ** 30

# ops whose output is index-like / boolean: never extreme-valued
_UNTAINT_OUT = frozenset({
    "eq", "ne", "lt", "le", "gt", "ge", "argmax", "argmin", "arange",
    "all", "any", "sign", "isfinite",
})
# ops that merely move values around: taint and guard search pass through
_PASS_THROUGH = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "expand_as",
    "broadcast_to", "cat", "stack", "slice", "select", "narrow", "squeeze",
    "unsqueeze", "transpose", "permute", "t", "_to_copy", "to",
    "constant_pad_nd", "gather", "index", "index_select", "take",
    "slice_scatter", "select_scatter", "flip", "clone", "copy", "detach",
    "alias", "lift_fresh_copy", "contiguous", "scatter", "index_put",
    "index_copy", "unbind", "split", "split_with_sizes",
})
# the literal arguments of value-moving ops that become array data, by
# position and keyword (``constant_pad_nd``'s fill, ``scatter.value``'s
# scalar); every other literal of a value-moving op is an index
_DATA_LITERALS = {"constant_pad_nd": (2, "value"), "scatter": (3, "value")}
# consuming one of these bounds the result again (or branches on the
# extreme case): the add is considered guarded
_GUARDS = frozenset({
    "minimum", "maximum", "clamp", "clamp_min", "clamp_max", "where",
    "amin", "amax",
})
_ARITH = frozenset({"add", "sub", "rsub", "mul"})


def _name(target) -> str:
    """``aten.add.Tensor`` -> ``"add"``; an in-place ``add_`` -> ``"add"``."""
    pkt = getattr(target, "overloadpacket", None)
    name = getattr(pkt, "__name__", None) or getattr(target, "__name__", "")
    return name[:-1] if name.endswith("_") and not name.startswith("_") \
        else name


def _is_int(val) -> bool:
    dt = getattr(val, "dtype", None)
    return dt is not None and not dt.is_floating_point and \
        not dt.is_complex and dt != torch.bool


def _literal_tainted(x) -> bool:
    """An int or float literal of magnitude >= 2^30 (aten passes a pad's
    fill as a float whatever the tensor's type)."""
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        return False
    return abs(x) >= TAINT_BOUND


def _const_tainted(t) -> bool:
    if not torch.is_tensor(t) or t.numel() == 0 or not _is_int(t):
        return False
    return bool(t.to(torch.int64).abs().max() >= TAINT_BOUND)


def _nodes_in(arg) -> List[torch.fx.Node]:
    if isinstance(arg, torch.fx.Node):
        return [arg]
    if isinstance(arg, (list, tuple)):
        return [n for a in arg for n in _nodes_in(a)]
    return []


def _literals_in(arg) -> List[Any]:
    if isinstance(arg, (list, tuple)):
        return [x for a in arg for x in _literals_in(a)]
    return [] if isinstance(arg, torch.fx.Node) else [arg]


def _fmt(node: torch.fx.Node) -> str:
    s = f"{node.name} = {node.target}{tuple(node.args)}"
    return s if len(s) <= 200 else s[:197] + "..."


class _Lint:
    def __init__(self, gm: torch.fx.GraphModule, tainted: Sequence[int],
                 program: str) -> None:
        self.gm = gm
        self.program = program
        self.tainted = set(tainted)
        self.taint: Dict[torch.fx.Node, Any] = {}
        out = [n for n in gm.graph.nodes if n.op == "output"]
        self.out_nodes = set(_nodes_in(out[0].args)) if out else set()
        self.n_sites = 0        # integer arithmetic with a tainted operand

    def _in_taint(self, node) -> List[bool]:
        """Taint of each operand: node arguments, and the literal
        arguments that are data (all of an op that computes; a
        value-moving op's :data:`_DATA_LITERALS` only)."""
        name = _name(node.target)
        data = _DATA_LITERALS.get(name, ()) if name in _PASS_THROUGH \
            else None
        t = []
        for key, a in (list(enumerate(node.args))
                       + list(node.kwargs.items())):
            for n in _nodes_in(a):
                v = self.taint.get(n, False)
                t.append(any(v) if isinstance(v, list) else bool(v))
            if data is None or key in data:
                t.extend(_literal_tainted(x) for x in _literals_in(a))
        return t

    # ---------------------------------------------------- forward pass ---
    def propagate(self) -> List[Tuple[torch.fx.Node, List[bool]]]:
        arith = []
        i = 0
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                self.taint[node] = i in self.tainted
                i += 1
            elif node.op == "get_attr":
                self.taint[node] = _const_tainted(
                    getattr(self.gm, node.target, None))
            elif node.op == "call_function":
                if node.target is operator.getitem:
                    src, k = node.args
                    v = self.taint.get(src, False)
                    self.taint[node] = v[k] if isinstance(v, list) else v
                    continue
                name = _name(node.target)
                in_t = self._in_taint(node)
                val = node.meta.get("val")
                multi = isinstance(val, (list, tuple))
                if name == "sort":
                    # co-sorted values keep their taint; indices do not
                    t0 = self.taint.get(node.args[0], False)
                    self.taint[node] = [bool(t0), False]
                elif name in ("max", "min") and multi:
                    self.taint[node] = [any(in_t), False]
                elif name in _UNTAINT_OUT:
                    self.taint[node] = ([False] * len(val) if multi
                                        else False)
                else:
                    self.taint[node] = ([any(in_t)] * len(val) if multi
                                        else any(in_t))
                if name in _ARITH and any(in_t):
                    arith.append((node, in_t))
        return arith

    # ------------------------------------------------- blessed idioms ---
    @staticmethod
    def _is_midpoint_idiom(node) -> bool:
        if _name(node.target) != "add" or len(node.args) != 2:
            return False
        x, y = node.args
        for a, b in ((x, y), (y, x)):
            if not (isinstance(a, torch.fx.Node)
                    and isinstance(b, torch.fx.Node)):
                continue
            if a.op != "call_function" or _name(a.target) != "bitwise_and":
                continue
            if b.op != "call_function" or _name(b.target) not in (
                    "__rshift__", "bitwise_right_shift"):
                continue
            xor = b.args[0]
            if isinstance(xor, torch.fx.Node) and xor.op == "call_function" \
                    and _name(xor.target) == "bitwise_xor" \
                    and set(_nodes_in(xor.args)) == set(_nodes_in(a.args)):
                return True
        return False

    # ----------------------------------------------------- guard search ---
    def guarded(self, node, depth: int = 8) -> bool:
        seen = set()
        frontier = [node]
        for _ in range(depth):
            nxt = []
            for n in frontier:
                if n in seen:
                    continue
                seen.add(n)
                if n in self.out_nodes:
                    return False        # leaves the graph unclamped
                for u in n.users:
                    if u.op != "call_function":
                        continue
                    if u.target is operator.getitem:
                        nxt.append(u)
                        continue
                    name = _name(u.target)
                    if name in _GUARDS:
                        return True
                    if name in _PASS_THROUGH:
                        nxt.append(u)
            if not nxt:
                break
            frontier = nxt
        return False

    # -------------------------------------------------------- verdicts ---
    def check(self) -> List[Violation]:
        out: List[Violation] = []
        for node, in_t in self.propagate():
            if not _is_int(node.meta.get("val")):
                continue
            self.n_sites += 1
            if sum(bool(t) for t in in_t) >= 2:
                if self._is_midpoint_idiom(node):
                    continue
                out.append(Violation(
                    "int32_overflow", self.program,
                    f"{_name(node.target)} with BOTH operands reachable "
                    f"from int32-extreme values (can wrap regardless of "
                    f"downstream guards): {_fmt(node)}",
                    {"kind": "both-extreme-add", "eqn": _fmt(node)}))
            elif not self.guarded(node):
                out.append(Violation(
                    "int32_overflow", self.program,
                    f"{_name(node.target)} on an int32-extreme operand whose "
                    f"result is never clamped (minimum/maximum/clamp) or "
                    f"selected around (where): {_fmt(node)}",
                    {"kind": "unclamped-extreme-add", "eqn": _fmt(node)}))
        return out


def lint_fn(fn, example_args: Sequence, *, program: str,
            tainted_args: Sequence[int] = ()) -> List[Violation]:
    """Trace ``fn(*example_args)`` to an aten graph (``make_fx``, real
    tensors) and lint it.  ``tainted_args`` are positional indices whose
    values are full-range int32 (keys, directory boundaries).  Pass
    distinct tensors: ``make_fx`` folds a tensor passed twice into one
    input.  The counterpart of ``lint_jaxpr``."""
    return _lint(fn, example_args, program, tainted_args)[0]


def _lint(fn, example_args: Sequence, program: str,
          tainted_args: Sequence[int]) -> Tuple[List[Violation], int]:
    """:func:`lint_fn`'s violations and the number of integer arithmetic
    sites with a tainted operand that it judged."""
    from torch.fx.experimental.proxy_tensor import make_fx
    lint = _Lint(make_fx(fn)(*example_args), tainted_args, program)
    return lint.check(), lint.n_sites


def check_int32_overflow() -> Tuple[List[Violation], Dict[str, Any]]:
    """Lint the port's ``core/scan_queue.py`` entries the wave path runs,
    the reference's six (``repro/analysis/overflow.py:301-318``), at its
    shapes (16 ops, 3 tiers, 4 buckets) on seeded CPU inputs.  Each
    entry's record gives its violations and ``tainted_sites``, the
    arithmetic sites it judged (none in ``strict_batch_deletemin``, whose
    inputs hold no extreme value, and in ``seap_bucket_lookup``, which
    only compares and selects keys)."""
    import functools

    from ..core import scan_queue as sq
    g = torch.Generator().manual_seed(0)
    n, P_, B_ = 16, 3, 4
    i32 = torch.int32

    def b(k):
        return torch.rand(k, generator=g) < 0.5

    def v(k, lo=0, hi=8):
        return torch.randint(lo, hi, (k,), generator=g, dtype=i32)

    def sc(x):
        return torch.tensor(x, dtype=i32)

    def queue_entry(e, first, last, valid):
        return sq.queue_scan(e, sq.QueueState(first, last), valid)

    def stack_entry(e, last, ticket, valid):
        return sq.stack_scan(e, sq.StackState(last, ticket), valid)

    lo = torch.tensor([sq.INT32_MIN, -5, 7, sq.INT32_MAX], dtype=i32)
    entries = [
        ("core/scan_queue.py:queue_scan", queue_entry,
         (b(n), sc(0), sc(-1), b(n)), ()),
        ("core/scan_queue.py:stack_scan", stack_entry,
         (b(n), sc(0), sc(0), b(n)), ()),
        ("core/scan_queue.py:strict_batch_deletemin",
         functools.partial(sq.strict_batch_deletemin, n_prios=P_),
         (b(n), v(P_), v(P_)), ()),
        ("core/scan_queue.py:priority_queue_scan",
         functools.partial(sq.priority_queue_scan, n_prios=P_),
         (b(n), v(n, 0, P_), b(n), v(P_), v(P_, 8, 16)), ()),
        ("core/scan_queue.py:seap_bucket_lookup", sq.seap_bucket_lookup,
         (v(n, -20, 20), lo.clone(), torch.tensor([True, True, False,
                                                   False])), (0, 1)),
        ("core/scan_queue.py:seap_queue_scan",
         functools.partial(sq.seap_queue_scan, n_buckets=B_,
                           split_occupancy=6),
         (b(n), v(n, -20, 20), b(n), v(B_), v(B_, 8, 16), lo.clone(),
          torch.tensor([True, True, False, False]), sc(sq.INT32_MAX),
          sc(sq.INT32_MIN)),
         (1, 5, 7, 8)),   # key, lo, key_lo, key_hi are full-range int32
    ]
    violations: List[Violation] = []
    info: Dict[str, Any] = {"entries": []}
    for name, fn, args, tainted in entries:
        vs, sites = _lint(fn, args, name, tainted)
        violations.extend(vs)
        info["entries"].append({"program": name, "violations": len(vs),
                                "tainted_sites": sites})
    return violations, info
