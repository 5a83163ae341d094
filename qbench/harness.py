"""One run of one cell: set-up, the measured window, the judgement.

Everything that belongs to one cell is found by name under the
benchmark's root (the directory of ``BENCHMARK.json``):

* the configuration's ``file``: a JSON object whose ``structure`` names
  ``qbench/structures/<structure>.py``, the adapter that builds the
  program's structure, runs a burst through its public entry point and
  holds the plain model of its answers;
* ``qbench/traffic/<traffic>.json``: the mix's parameters, read by the one
  generator (``generator.py``) and by the driver below: the burst's
  waves, the enqueue shares, the valid ops a shard, the share of bursts
  judged op by op, and the membership changes;
* ``qbench/end_to_end/<metric>.py`` and ``qbench/metrics/<metric>.py``:
  one reader a metric, ``read(run) -> float | None``.

A run fills the structure to the configuration's ``backlog`` and warms
every shape the window uses (set-up), then drives the traffic for the
window's seconds in a closed loop: each burst is submitted when the one
before it has completed, and after every ``every_bursts`` bursts the
structure takes the next membership change of the mix.  The outputs the
judgement needs stay on the device until the window has closed, as
copies whose bytes the harness counts, so that ``memory_peak_bytes`` is
the program's own peak (with the inputs of the burst in flight) and not
the harness's.  Then the plain model works
every answer out again from the same inputs: every wave's flags and
every size the program reports are compared with it, and every output of
a sample of the bursts, drawn from the seed (the first and the last
among them), op by op.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from .generator import Burst, OpStream, drop_inputs, fingerprint, regenerate
from .reference.payload import words

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
PROFILE_MARK = "qbench:profiled"


@dataclass
class Resize:
    """One JOIN or LEAVE: the time the structure took no wave."""
    phase: str
    kind: str                     # "join" or "leave"
    t_due: float
    t_done: float
    n_shards: int                 # after the change
    size: int                     # the program's live elements after it
    stats: dict                   # the port's migration stats


@dataclass
class Run:
    """What a metric's reader may read of a run."""
    cfg: dict
    traffic: dict
    adapter: object
    setup_s: float = 0.0
    window_s: float = 0.0
    bursts: list = field(default_factory=list)     # the window's
    resizes: list = field(default_factory=list)    # the window's
    spans: list = field(default_factory=list)      # the port's burst
    #                                                spans, unprofiled
    profiled: list = field(default_factory=list)   # bursts profiled
    trace: object = None
    stalls: dict = field(default_factory=dict)     # see _HostStalls


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, workload: str) -> tuple:
    """(benchmark, cell, configuration, traffic, adapter) of a cell."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / "qbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    adapter = load_module(
        root / "qbench" / "structures" / f"{cfg['structure']}.py",
        f"qbench_structure_{cfg['structure']}")
    return bench, cell, cfg, traffic, adapter


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: its end-to-end ones,
    or with ``trace`` its per-layer ones (those that list the cell, or
    list no cells and move an end-to-end metric the cell reports)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's,
    Flax's, the JAX package's or its benchmarks'."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def percentile(pairs, q: float) -> float:
    """Nearest-rank ``q`` quantile (``q`` in (0, 1]) of the values given
    as pairs ``(value, count)``: ``count`` values equal to ``value``."""
    v, c = np.asarray(pairs, np.float64).reshape(-1, 2).T
    order = np.argsort(v, kind="stable")
    cum = np.cumsum(c[order])
    rank = max(1.0, np.ceil(q * cum[-1] - 1e-9))
    return float(v[order][np.searchsorted(cum, rank)])


class Driver:
    """Drives one structure through bursts and membership changes, and
    keeps every event for the judgement.

    What the harness keeps on the device (the outputs to be judged, each
    burst's per-wave outputs and input fingerprint) is a copy made after
    the burst, its bytes counted from the allocator as it is made
    (``held_bytes``).  ``peak_bytes`` is the most the allocator held
    during the structure's build, any burst or any membership change,
    less what the harness held then: the program's own peak."""

    def __init__(self, q, adapter, stream: OpStream, cfg: dict,
                 traffic: dict, device: torch.device):
        self.q, self.adapter, self.stream = q, adapter, stream
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.K = int(traffic["waves_per_burst"])
        self.full = int(cfg["ops_per_shard"])
        self.per_shard = traffic.get("valid_per_shard")
        self.events: list = []
        self._steps = 0
        self.held_bytes = 0
        self.peak_bytes = self._peak()

    def sync(self):
        """Wait for the device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _allocated(self) -> int:
        if self.device.type != "cuda":
            return 0
        return torch.cuda.memory_allocated(self.device)

    def _peak(self) -> int:
        """The allocator's peak since the last reset, less what the
        harness holds."""
        if self.device.type != "cuda":
            return 0
        return torch.cuda.max_memory_allocated(self.device) - self.held_bytes

    def _reset_peak(self):
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def width(self) -> int:
        """The mix's wave width at the structure's shard count: the full
        width, or the narrowest of the ladder that holds
        ``valid_per_shard`` ops a shard."""
        if self.per_shard is None:
            return self.full
        return int(self.q.pick_width(self.q.n_shards * int(self.per_shard)))

    def make(self, phase: str) -> Burst:
        """The mix's next burst at the structure's shard count."""
        return self.stream.burst(phase, self.q.n_shards, self.width(),
                                 self.K, self.traffic["enq_share"],
                                 self.per_shard)

    def burst(self, phase: str, judged: bool) -> Burst:
        """One burst of the mix, run and kept (``judged``: all of its
        outputs, for the judgement op by op)."""
        b = self.make(phase)
        self.keep(b, self.run(b), judged)
        return b

    def run(self, b: Burst) -> dict:
        """Run the burst ``b`` and wait for its outputs."""
        self.sync()
        self._reset_peak()
        b.t_due = time.perf_counter()
        out = self.adapter.run(self.q, b)
        self.sync()
        b.t_done = time.perf_counter()
        self.peak_bytes = max(self.peak_bytes, self._peak())
        return out

    def keep(self, b: Burst, out: dict, judged: bool) -> None:
        """Copy what the judgement needs of ``b``'s outputs, count its
        bytes, and let the program's outputs and the inputs go."""
        a0 = self._allocated()
        b.waves = {k: out[k].clone() for k in self.adapter.PER_WAVE}
        b.outputs = ({k: v.clone() for k, v in out.items()} if judged
                     else None)
        b.fingerprint = fingerprint(b)
        self.held_bytes += self._allocated() - a0
        b.judged = judged
        drop_inputs(b)
        self.events.append(b)

    def resize_due(self, n_bursts: int) -> bool:
        """Whether the mix changes membership after ``n_bursts``."""
        rs = self.traffic.get("resize")
        return bool(rs) and n_bursts % int(rs["every_bursts"]) == 0

    def resize(self, phase: str) -> Resize:
        """The mix's next membership change: ``{"leave": [lo, hi]}``
        shrinks by the shards ``lo .. hi - 1``, ``{"join": k}`` grows by
        ``k``."""
        steps = self.traffic["resize"]["steps"]
        step = steps[self._steps % len(steps)]
        self._steps += 1
        self.sync()
        self._reset_peak()
        t0 = time.perf_counter()
        if "leave" in step:
            kind = "leave"
            stats = self.q.shrink(list(range(*step["leave"])))
        else:
            kind = "join"
            stats = self.q.grow(int(step["join"]))
        self.sync()
        t1 = time.perf_counter()
        self.peak_bytes = max(self.peak_bytes, self._peak())
        r = Resize(phase, kind, t0, t1, self.q.n_shards, int(self.q.size),
                   dict(stats))
        self.events.append(r)
        return r

    def setup(self):
        """Fill to the configuration's backlog with enqueue-only bursts at
        the full width, then one cycle of the window's pattern, so that
        every shape the window uses has run."""
        backlog, filled = int(self.cfg["backlog"]), 0
        while filled < backlog:
            b = self.stream.burst("fill", self.q.n_shards, self.full, self.K,
                                  1.0, n_valid=backlog - filled)
            self.keep(b, self.run(b), True)
            filled += b.n_ops
        rs = self.traffic.get("resize")
        for _ in (rs["steps"] if rs else ()):
            for _ in range(int(rs["every_bursts"])):
                self.burst("warm", True)
            self.resize("warm")
        self.burst("warm", True)


def judge(events: list, adapter, cfg: dict, final_size: int, seed: int,
          device) -> tuple:
    """Hold every event against the plain model, run on ``device`` once
    the program's state is freed, on the inputs made again from the
    seed.  Returns the numbers compared, each ``{"value": n, "limit":
    0}``, and the number of ops judged one by one."""
    max_burst = max(e.K * e.n for e in events if isinstance(e, Burst))
    model = adapter.model(cfg, max_burst, device)
    stream = OpStream(seed, device, cfg["payload_width"], adapter.draw_extra,
                      cfg)
    W = int(cfg["payload_width"])
    wrong_ops = wrong_waves = wrong_sizes = judged_ops = 0
    for ev in events:
        if isinstance(ev, Resize):
            wrong_sizes += int(ev.size != model.size)
            continue
        K, n = ev.K, ev.n
        b = regenerate(ev, stream)
        inputs = {"is_enq": b.is_enq, "valid": b.valid, "ids": b.ids,
                  "n_shards": b.n_shards, **b.extra}
        want = adapter.expect(model, cfg, inputs,
                              answers=ev.outputs is not None)
        for key in adapter.PER_WAVE:
            got = ev.waves[key].reshape(K).cpu()
            wrong_waves += int((got != want[key].reshape(K).cpu()).sum())
        if ev.outputs is None:
            continue
        out = ev.outputs
        bad = torch.zeros((K, n), dtype=torch.bool, device=device)
        for key in adapter.PER_OP:
            bad |= out[key].reshape(K, n) != want[key]
        ok = want["deq_ok"]
        vals = torch.zeros((K, n, W), dtype=torch.int32, device=device)
        vals[ok] = words(want["deq_ids"][ok], W)
        bad |= (out["deq_vals"].reshape(K, n, W) != vals).any(-1)
        wrong_ops += int(bad.sum())
        judged_ops += K * n
    wrong_sizes += int(final_size != model.size)
    return {"wrong_ops": {"value": wrong_ops, "limit": 0},
            "wrong_waves": {"value": wrong_waves, "limit": 0},
            "wrong_sizes": {"value": wrong_sizes, "limit": 0}}, judged_ops


class _Profiled:
    """``torch.profiler`` over the stretch, marked by a host range."""

    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.mark = torch.profiler.record_function(PROFILE_MARK)

    def __enter__(self):
        self.prof.__enter__()
        self.mark.__enter__()
        return self

    def __exit__(self, *exc):
        self.mark.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False


def window(drv: Driver, run: Run, seconds: float, seed: int, trace: bool):
    """The measured window; with ``trace`` its first cycle of bursts (and
    the membership changes among them) under the profiler, which is
    returned, finished, to be read once the window has closed."""
    from repro_torch.obs.trace import tracer
    rs = drv.traffic.get("resize")
    cycle = (int(rs["every_bursts"]) * len(rs["steps"]) if rs
             else int(drv.traffic["profile_bursts"]))
    finished = []
    n_spans = [len(tracer.events())]

    def start():
        return _Profiled(drv.device).__enter__() if trace else None

    def stop(prof):
        drv.sync()
        prof.__exit__(None, None, None)
        run.profiled = list(run.bursts)
        finished.append(prof)
        n_spans[0] = len(tracer.events())

    with _HostStalls(drv.device) as stalls:
        _closed_window(drv, run, seconds, seed, cycle, start, stop)
    run.stalls = stalls.record
    run.spans = [s for s in tracer.events()[n_spans[0]:]
                 if s["name"] == drv.adapter.SPAN]
    return finished[0] if finished else None


class _HostStalls:
    """What can stall the host inside the window: the interpreter's
    garbage collections (count and seconds) and the device allocator's
    calls to the driver (segments allocated and freed, retries after a
    failed allocation)."""

    KEYS = ("num_device_alloc", "num_device_free", "num_alloc_retries")

    def __init__(self, device: torch.device):
        self.device = device
        self.record = {"gc_collections": 0, "gc_s": 0.0}
        self._t = None

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.record["gc_collections"] += 1
            self.record["gc_s"] += time.perf_counter() - self._t

    def _alloc(self) -> dict:
        if self.device.type != "cuda":
            return {}
        stats = torch.cuda.memory_stats(self.device)
        return {k: stats.get(k, 0) for k in self.KEYS}

    def __enter__(self):
        self._a0 = self._alloc()
        gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)
        self.record.update({k: v - self._a0[k]
                            for k, v in self._alloc().items()})
        return False


def _closed_window(drv: Driver, run: Run, seconds: float, seed: int,
                   cycle: int, start, stop):
    """Bursts back to back for ``seconds``, each submitted when the one
    before it is complete, with the mix's membership changes between
    them."""
    pick = np.random.default_rng([int(seed) % (1 << 63), 1])
    share = float(drv.traffic["judge_share"])
    prof = start()
    t_start = time.perf_counter()
    while True:
        judged = not run.bursts or bool(pick.random() < share)
        b = drv.make("window")
        out = drv.run(b)
        done = time.perf_counter() - t_start >= seconds
        drv.keep(b, out, judged or done)  # the last burst is judged too
        del out
        run.bursts.append(b)
        if not done and drv.resize_due(len(run.bursts)):
            run.resizes.append(drv.resize("window"))
        if prof is not None and (done or len(run.bursts) >= cycle):
            stop(prof)
            prof = None
        if done:
            break
    run.window_s = time.perf_counter() - t_start


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, *, device="cuda", t_process: Optional[float] = None,
             build: Optional[Callable] = None) -> dict:
    """Run ``workload`` once; return the result line's object.  ``build``
    stands in for the adapter's (the tests put a broken structure in the
    program's place)."""
    t0 = time.perf_counter() if t_process is None else t_process
    parts = {"start_s": time.perf_counter() - t0}
    root = Path(root)
    bench, cell, cfg, traffic, adapter = load_cell(root, workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    q = (build or adapter.build)(cfg, dev)
    stream = OpStream(seed, dev, cfg["payload_width"], adapter.draw_extra,
                      cfg)
    drv = Driver(q, adapter, stream, cfg, traffic, dev)
    drv.sync()
    parts["structure_s"] = time.perf_counter() - t0 - parts["start_s"]
    drv.setup()
    drv.sync()
    run = Run(cfg, traffic, adapter)
    run.setup_s = time.perf_counter() - t0
    parts["bursts_s"] = run.setup_s - parts["structure_s"] - parts["start_s"]
    profiled = window(drv, run, seconds, seed, trace)
    drv.sync()
    peak = drv.peak_bytes
    final_size = int(q.size)
    del q
    drv.q = None                          # the program's state goes first
    if profiled is not None:
        from .profile import collect
        run.trace = collect(profiled.prof)
    t_judge = time.perf_counter()
    checks, judged_ops = judge(drv.events, adapter, cfg, final_size, seed,
                               dev)
    t_judge = time.perf_counter() - t_judge
    kind = "metrics" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        reader = load_module(root / "qbench" / kind / f"{m['name']}.py",
                             f"qbench_{kind}_{m['name'].replace('.', '_')}")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                  "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct),
              "attempted": int(sum(b.n_ops for b in run.bursts)),
              "failed": 0, "metrics": metrics, "device": device_rec}
    if run.trace is not None:
        device_rec["busy_s"] = run.trace.busy_s
        device_rec["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["run"] = {"judged_ops": judged_ops, "judge_s": t_judge,
                     "setup": parts, "held_bytes": drv.held_bytes,
                     **_run_record(run)}
    result["checks"] = checks
    return result


def _run_record(run: Run) -> dict:
    """What the run did, for the reader of its result: bursts, resizes,
    the window, how long bursts took and the gaps between them."""
    rec = {"bursts": len(run.bursts), "resizes": len(run.resizes),
           "judged_bursts": sum(b.judged for b in run.bursts),
           "window_s": run.window_s, "stalls": run.stalls}
    if run.bursts:
        ms = np.array([(b.t_done - b.t_due) * 1e3 for b in run.bursts])
        gaps = np.array([(b.t_due - a.t_done) * 1e3
                         for a, b in zip(run.bursts, run.bursts[1:])] or [0.])
        p50 = float(np.median(ms))
        rec["burst_ms"] = {"p50": p50, "max": float(ms.max()),
                           "over_2x_p50": int((ms > 2 * p50).sum()),
                           "excess_s": float(np.clip(ms - p50, 0, None).sum()
                                             / 1e3)}
        rec["gap_ms"] = {"max": float(gaps.max()), "sum": float(gaps.sum())}
    return rec
