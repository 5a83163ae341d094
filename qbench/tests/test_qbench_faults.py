"""The judgement refuses the controls and a program broken underneath.

Each cell runs on the CPU at the small size (``small.py``) through the
whole harness but for the look for a card: the program as it is comes
out correct; the control (``qbench/control.py``, the plain model with a
stated guarantee broken) and the program with one fault planted come out
not correct.  The faults: a burst that leaves the state as it found it;
half of every wave's ops left out; the exchange between shards left out;
one dequeued word altered, and one op's matched flag flipped, where the
outputs are produced.
"""
import pytest
import torch

from qbench import control, harness
from qbench.tests.small import EXTRA_CELLS, small_root

CELLS = ("fifo_64x64k.bulk", "pqueue_64x4t.bulk",
         "fifo_64x64k.churn") + EXTRA_CELLS
SECONDS = 0.25
# where run_waves' outputs sit: (matched, deq_vals, deq_ok)
OUTS = {"fifo": (1, 2, 3), "priority": (2, 3, 4)}


class Faulty:
    """The program's structure with one fault planted."""

    def __init__(self, q, fault: str, structure: str):
        self.q, self.fault = q, fault
        self.matched, self.vals, self.ok = OUTS[structure]
        if fault == "exchange_left_out":
            q.runtime.exchange = lambda buf, src=None, dst=None: buf

    def __getattr__(self, name):
        return getattr(self.q, name)

    def run_waves(self, is_enq, valid, *rest):
        if self.fault == "half_batch_left_out":
            valid = valid.clone()
            valid[:, valid.shape[1] // 2:] = False
        if self.fault == "state_unchanged":
            kept = [x.clone() for x in self.q.state]
        out = list(self.q.run_waves(is_enq, valid, *rest))
        if self.fault == "state_unchanged":
            self.q.state = type(self.q.state)(*kept)
        if self.fault == "answer_altered":
            hit = torch.nonzero(out[self.ok])
            if hit.numel():
                k, j = hit[0].tolist()
                out[self.vals] = out[self.vals].clone()
                out[self.vals][k, j, 0] ^= 1
        if self.fault == "matched_flipped":
            out[self.matched] = out[self.matched].clone()
            out[self.matched][0, 0] = ~out[self.matched][0, 0]
        return tuple(out)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("qbench"))


def _run(root, cell, build=None, seed=2 ** 31 + 17):
    return harness.run_cell(root, cell, seed, SECONDS, False, device="cpu",
                            build=build)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_comes_out_correct(root, cell):
    r = _run(root, cell)
    assert r["correct"], r["checks"]
    assert r["run"]["judged_ops"] > 0
    assert list(r["checks"])[-1] == "wrong_sizes"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_comes_out_not_correct(root, cell):
    r = _run(root, cell, control.build)
    assert not r["correct"]
    assert r["checks"]["wrong_ops"]["value"] > 100


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch_left_out",
                                   "exchange_left_out", "answer_altered",
                                   "matched_flipped"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_comes_out_not_correct(root, cell, fault):
    def build(cfg, device):
        q = harness.load_cell(root, cell)[4].build(cfg, device)
        return Faulty(q, fault, cfg["structure"])
    try:
        r = _run(root, cell, build)
    except RuntimeError:
        # a migration's exchange, left out, breaks the store's shape: the
        # run ends without a result, which refuses it as well
        assert (cell, fault) == ("fifo_64x64k.churn", "exchange_left_out")
        return
    assert not r["correct"], (fault, r["checks"])
