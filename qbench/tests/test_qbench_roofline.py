"""The byte counts follow from the scans' shapes, and the trace reader
adds up what a trace holds."""
import pytest
import torch

from qbench import roofline
from qbench.profile import Trace, short_name
from repro_torch.kernels.segscan import queue_scan, tiered_queue_scan

N, P = 65_536, 4


def _nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def test_queue_scan_bytes_follow_from_its_shapes():
    e = torch.rand(N) < 0.5
    v = torch.ones(N, dtype=torch.bool)
    first = torch.tensor(0, dtype=torch.int32)
    last = torch.tensor(99, dtype=torch.int32)
    pos, matched, f, la = queue_scan(e, v, first, last)
    want = _nbytes(e, v, first, last) + _nbytes(pos, matched, f, la)
    assert roofline.queue_scan_bytes(N) == want == 7 * N + 16


def test_tiered_scan_bytes_follow_from_its_shapes():
    enq = torch.rand(N) < 0.5
    tier = torch.randint(0, P, (N,), dtype=torch.int32)
    firsts = torch.zeros(P, dtype=torch.int32)
    lasts = torch.full((P,), 9, dtype=torch.int32)
    pos, new_lasts = tiered_queue_scan(enq, tier, firsts, lasts, P)
    # the kernel reads the tiers' lasts, not their firsts
    want = _nbytes(enq, tier, lasts) + _nbytes(pos, new_lasts)
    assert roofline.tiered_scan_bytes(N, P) == want == 9 * N + 8 * P


def test_share_percent():
    # 3.35 MB in one microsecond is the peak itself
    assert roofline.share_percent(3.35e6, 1e-6) == pytest.approx(100.0)


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_trace_reads_busy_time_ranges_kernels_and_gaps():
    events = [
        _ev("user_annotation", "qbench:profiled", 0, 100),
        _ev("user_annotation", "wave:queue:burst", 5, 30),
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 1, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 50, 1, correlation=3),
        _ev("kernel", "void (anonymous namespace)::queue_scan_lookback("
            "unsigned char const*)", 12, 8, correlation=1),
        _ev("kernel", "void at::native::gather<16, long>(int)", 15, 20,
            correlation=2),
        _ev("gpu_memcpy", "Memcpy DtoH", 60, 10, correlation=3),
        _ev("cpu_op", "aten::copy_", 40, 25),
    ]
    t = Trace(events)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(33e-6)          # [12, 35) and [60, 70)
    assert t.device_us_within({"wave:queue:burst"}) == (28.0, 1)
    assert t.kernel_us("queue_scan_lookback") == [8.0]
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["at::native::gather<16, long>",
                                   pytest.approx(20e-6)]
    gaps = dict((k, v) for k, v in bd["idle_gaps"])      # by the midpoint
    assert gaps["wave:queue:burst"] == pytest.approx(12e-6)          # 0-12
    assert gaps["qbench:profiled/aten::copy_"] == pytest.approx(25e-6)
    assert gaps["qbench:profiled"] == pytest.approx(30e-6)          # 70-100


def test_short_name():
    assert short_name("void (anonymous namespace)::relaxed_deletemin"
                      "<false, false>(int const*)") == \
        "relaxed_deletemin<false, false>"
