"""The per-layer metrics that read the port's stage spans, its
exchange-bytes counter and its migration timings: the stage readers on
a made-up trace, and a traced run of each cell at the CPU's size, whose
``exchange_bytes_per_op`` is the closed form of its bursts' shard
counts."""
import json

import pytest

from qbench import harness
from qbench.profile import Trace
from qbench.tests.small import ROOT, small_root

SECONDS = 2.0
CELLS = ("fifo_64x64k.bulk", "pqueue_64x4t.bulk", "fifo_64x64k.churn")
STAGE_METRICS = {"dispatch_device_ms": ("wave:dispatch", 0),
                 "exchange_device_ms": ("wave:exchange", 1),
                 "commit_device_ms": ("wave:commit", 1)}


def _reader(name: str):
    return harness.load_module(ROOT / "qbench" / "metrics" / f"{name}.py",
                               f"qbench_test_metric_{name}")


class _Burst:
    def __init__(self, K: int):
        self.K = K


class _Run:
    """What the readers read of a run, and nothing else."""

    def __init__(self, trace=None, profiled=(), spans=(), resizes=()):
        self.trace, self.profiled = trace, list(profiled)
        self.spans, self.resizes = list(spans), list(resizes)


def _trace(ranges: dict) -> Trace:
    """A trace whose ranges ``{name: [device us of each range]}`` each
    launch one kernel from inside; range i of a name starts at 100·i."""
    events, corr, t = [], 0, 0.0
    for name, durs in ranges.items():
        for d in durs:
            corr += 1
            t += 100.0
            events += [
                {"ph": "X", "cat": "user_annotation", "name": name,
                 "ts": t, "dur": 10.0},
                {"ph": "X", "cat": "cuda_runtime", "name": "launch",
                 "ts": t + 1.0, "dur": 1.0, "args": {"correlation": corr}},
                {"ph": "X", "cat": "kernel", "name": "k", "ts": t + 5.0,
                 "dur": d, "args": {"correlation": corr}}]
    return Trace(events)


@pytest.mark.parametrize("metric", sorted(STAGE_METRICS))
def test_stage_reader_on_a_made_up_trace(metric):
    name, extra = STAGE_METRICS[metric]
    read = _reader(metric).read
    bursts = [_Burst(3), _Burst(2)]
    n = 5 + extra * len(bursts)              # ranges the stage shows
    durs = [float(10 * (i + 1)) for i in range(n)]
    other = {"wave:other": [1000.0]}         # launched outside the stage
    run = _Run(_trace({name: durs, **other}), bursts)
    assert read(run) == pytest.approx(sum(durs) / 1e3 / 5)
    # a range missing (the parent's program has none at all): nothing
    assert read(_Run(_trace({name: durs[1:], **other}), bursts)) is None
    assert read(_Run(_trace(other), bursts)) is None
    assert read(_Run(None, bursts)) is None


def test_bytes_and_host_readers_read_nothing_without_their_args():
    spans = [{"name": "queue:burst", "args": {"K": 16, "n_shards": 64}}]
    assert _reader("exchange_bytes_per_op").read(_Run(spans=spans)) is None
    spans = [{"args": {"exchange_bytes": 300, "ops": 2}},
             {"args": {"exchange_bytes": 100, "ops": 2}}]
    assert _reader("exchange_bytes_per_op").read(_Run(spans=spans)) == 100

    class _Resize:
        def __init__(self, stats):
            self.stats = stats
    read = _reader("migration_host_ms").read
    assert read(_Run(resizes=[_Resize({"wave_s": 0.01})])) is None
    assert read(_Run(resizes=[_Resize({"host_s": 0.001}),
                              _Resize({"host_s": 0.003})])) == \
        pytest.approx(2.0)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The small root with a profiled stretch of one burst (churn: one
    cycle of a burst and a resize, twice), so that bursts outside it fill
    most of the window however slow the profiler runs here."""
    root = small_root(tmp_path_factory.mktemp("qbench_tracing"))
    for f in (root / "qbench" / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        mix["profile_bursts"] = 1
        if "resize" in mix:
            mix["resize"]["every_bursts"] = 1
        f.write_text(json.dumps(mix))
    return root


def _traced(root, cell: str, monkeypatch):
    """A traced run of ``cell`` and its ``Run``."""
    runs = []
    real = harness.window

    def spy(drv, run, *a):
        runs.append(run)
        return real(drv, run, *a)
    monkeypatch.setattr(harness, "window", spy)
    r = harness.run_cell(root, cell, 2 ** 31 + 29, SECONDS, True,
                         device="cpu")
    return r, runs[0]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_closed_form(root, cell, monkeypatch):
    r, run = _traced(root, cell, monkeypatch)
    assert r["correct"], r["checks"]
    L, W = int(run.cfg["ops_per_shard"]), int(run.cfg["payload_width"])
    # a pipelined K-wave burst over n shards: K request ‖ reply buffers
    # and one reply-only epilogue, int32 [n, n, L, C]
    req, rep = 2 + W, 1 + W
    n_bytes = sum(4 * s["args"]["n_shards"] ** 2 * L
                  * (s["args"]["K"] * (req + rep) + rep) for s in run.spans)
    n_ops = sum(s["args"]["K"] * s["args"]["n_shards"] * L
                for s in run.spans)
    assert run.spans and n_ops
    got = r["metrics"]["exchange_bytes_per_op"]
    assert got["value"] == n_bytes / n_ops and got["unit"] == "B/op"
    if cell.endswith(".bulk"):              # 8 shards: 8 · (44 + 20 / 4)
        assert got["value"] == 392
    # the profiled stretch holds the stage ranges the readers count
    names = [nm for nm, _, _ in run.trace.ranges]
    waves, bursts = sum(b.K for b in run.profiled), len(run.profiled)
    assert bursts and names.count("wave:dispatch") == waves
    assert names.count("wave:exchange") == waves + bursts
    assert names.count("wave:commit") == waves + bursts
    if cell.endswith(".churn"):
        assert {s["args"]["n_shards"] for s in run.spans} == {6, 8}
        host = r["metrics"]["migration_host_ms"]["value"]
        assert host > 0
        for z in run.resizes:             # inside the harness's timing
            assert (z.stats["host_s"] + z.stats["wave_s"]
                    <= z.t_done - z.t_due)
    else:
        assert "migration_host_ms" not in r["metrics"]
