"""The port's protocol engine: the reference's end-to-end cases
(sequential consistency, Theorems 14/21; runtime scaling, Theorem 15;
batch bounds, Theorems 18/20; membership, Section IV) on
``repro_torch.core``, under both the synchronous and the adversarial
asynchronous scheduler; then the port's ``Skueue`` against the
reference's on the same seeds and schedules (queue and stack, sync and
async, with and without JOIN/LEAVE and the anchor's leave): every
request's record, the message count, the batch bound, the anchor state,
the update phases and the checker's result must be equal."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from _hyp import given, settings, strategies as st

from repro.core.consistency import \
    check_sequential_consistency as ref_check
from repro.core.protocol import Skueue as RefSkueue

from repro_torch.core.consistency import (ConsistencyViolation,
                                          check_sequential_consistency)
from repro_torch.core.protocol import DEQ, ENQ, Skueue


def _inject_random(sk, n_reqs, p_enq, rng):
    nids = sk.ring.node_ids()
    for _ in range(n_reqs):
        sk.inject(nids[int(rng.integers(len(nids)))],
                  ENQ if rng.random() < p_enq else DEQ)


# ---------------------------------------------------------------- queue ----
@pytest.mark.parametrize("n,p_enq", [(3, 0.5), (8, 0.75), (8, 0.25), (16, 0.5)])
def test_queue_sync_consistent(n, p_enq):
    sk = Skueue(n, mode="queue", seed=n)
    rng = np.random.default_rng(n * 7 + 1)

    def inject(s, rnd):
        if rnd <= 40:
            _inject_random(s, 3, p_enq, rng)
    sk.run_rounds(80, inject_fn=inject)
    stats = check_sequential_consistency(sk)
    assert stats["n_requests"] == 120
    sk.check_dht_placement()


@given(seed=st.integers(0, 10_000), n=st.integers(2, 10),
       p_enq=st.floats(0.1, 0.9))
@settings(max_examples=25, deadline=None)
def test_queue_async_adversarial_consistent(seed, n, p_enq):
    """Definition 1 holds for every asynchronous schedule we can generate."""
    sk = Skueue(n, mode="queue", seed=seed)
    _inject_random(sk, 40, p_enq, np.random.default_rng(seed + 1))
    assert sk.run_async(max_steps=400_000)
    check_sequential_consistency(sk)


def test_queue_matches_fifo_when_single_process():
    """With one process the distributed queue == a classical queue."""
    sk = Skueue(1, mode="queue", seed=0)
    nid = sk.ring.node_ids()[0]
    for k in [ENQ, ENQ, DEQ, ENQ, DEQ, DEQ, DEQ, ENQ, DEQ]:
        sk.inject(nid, k)
    sk.run_rounds(5)
    check_sequential_consistency(sk)  # replay IS the classical-queue check


def test_fifo_order_across_processes():
    """Elements injected in one quiesced wave leave in position order."""
    sk = Skueue(4, mode="queue", seed=2)
    nids = sk.ring.node_ids()
    for i in range(10):
        sk.inject(nids[i % len(nids)], ENQ)
    sk.run_rounds(100)
    for i in range(10):
        sk.inject(nids[(3 * i) % len(nids)], DEQ)
    sk.run_rounds(100)
    assert check_sequential_consistency(sk)["n_requests"] == 20
    deqs = sorted((r.order, r.result) for r in sk.requests if r.kind == DEQ)
    enq_pos = {r.elem: r.pos for r in sk.requests if r.kind == ENQ}
    served = [enq_pos[res] for _, res in deqs]
    assert served == sorted(served), "FIFO: dequeues return ascending positions"


# ---------------------------------------------------------------- stack ----
@pytest.mark.parametrize("n,p_push", [(4, 0.5), (8, 0.7), (8, 0.3)])
def test_stack_sync_consistent(n, p_push):
    sk = Skueue(n, mode="stack", seed=n + 100)
    rng = np.random.default_rng(n * 13 + 1)

    def inject(s, rnd):
        if rnd <= 40:
            _inject_random(s, 3, p_push, rng)
    sk.run_rounds(100, inject_fn=inject)
    check_sequential_consistency(sk)


@given(seed=st.integers(0, 10_000), n=st.integers(2, 8),
       p=st.floats(0.2, 0.8))
@settings(max_examples=20, deadline=None)
def test_stack_async_adversarial_consistent(seed, n, p):
    sk = Skueue(n, mode="stack", seed=seed)
    _inject_random(sk, 30, p, np.random.default_rng(seed + 3))
    assert sk.run_async(max_steps=600_000)
    check_sequential_consistency(sk)


def test_stack_local_combining_fast_path():
    """Sec. VI: locally paired push/pop complete without any DHT traffic."""
    sk = Skueue(4, mode="stack", seed=7)
    nid = sk.ring.node_ids()[0]
    sk.inject(nid, ENQ)
    rid = sk.inject(nid, DEQ)
    req = sk.requests[rid]
    assert req.done and req.result == sk.requests[rid - 1].elem
    assert sk.total_msgs == 0  # answered before any message was sent


def test_stack_batches_constant_size():
    """Theorem 20: stack batches aggregate to at most (pop-run, push-run)."""
    sk = Skueue(6, mode="stack", seed=9)
    rng = np.random.default_rng(11)

    def inject(s, rnd):
        if rnd <= 60:
            _inject_random(s, 6, 0.5, rng)
    sk.run_rounds(120, inject_fn=inject)
    check_sequential_consistency(sk)
    assert sk.stats_batch_max_runs <= 3  # (maybe-empty push, pop, push)


# --------------------------------------------------------------- runtime ---
def test_latency_scales_logarithmically():
    """Theorem 15 / Figure 2: mean rounds/request grows ~ log n."""
    means = []
    for n in (4, 16, 64):
        sk = Skueue(n, mode="queue", seed=n)
        rng = np.random.default_rng(n)

        def inject(s, rnd):
            if rnd <= 30:
                _inject_random(s, 2, 0.5, rng)
        sk.run_rounds(60, inject_fn=inject)
        check_sequential_consistency(sk)
        means.append(np.mean([r.t_done - r.t_issue for r in sk.requests]))
    # monotone-ish growth, far from linear: 16x nodes << 16x latency
    assert means[2] < means[0] * 6
    assert means[2] / np.log2(64 * 3) < 3 * means[0] / np.log2(4 * 3) + 10


def test_queue_batch_size_logarithmic():
    """Theorem 18: queue batches stay O(log n) runs under 1 req/round/node."""
    n = 32
    sk = Skueue(n, mode="queue", seed=5)
    rng = np.random.default_rng(6)

    def inject(s, rnd):
        if rnd <= 60:
            for nid in s.ring.node_ids():
                s.inject(nid, ENQ if rng.random() < 0.5 else DEQ)
    sk.run_rounds(120, inject_fn=inject)
    check_sequential_consistency(sk)
    assert sk.stats_batch_max_runs <= 6 * np.log2(3 * n)


# ------------------------------------------------------------ membership ---
def test_join_leave_churn_queue():
    sk = Skueue(6, mode="queue", seed=17)
    rng = np.random.default_rng(19)

    def inject(s, rnd):
        nids = s.ring.node_ids()
        if rnd % 3 == 0 and rnd <= 150:
            s.inject(nids[int(rng.integers(len(nids)))],
                     ENQ if rng.random() < 0.6 else DEQ)
        if rnd in (10, 20):
            s.request_join()
        if rnd == 35:
            s.request_leave(2)
        if rnd == 50:
            s.request_leave(0)
    sk.run_rounds(300, inject_fn=inject)
    check_sequential_consistency(sk)
    sk.check_dht_placement()
    assert set(sk.ring.proc[n] for n in sk.ring.node_ids()) == \
        {1, 3, 4, 5, 6, 7}
    assert sk.pending_membership == 0
    assert sk.ring.size == 24  # 18 original + 6 joined virtual nodes


def test_anchor_process_leave_hands_off():
    sk = Skueue(5, mode="queue", seed=23)
    anchor_proc = sk.ring.proc[sk.ring.anchor]
    rng = np.random.default_rng(29)

    def inject(s, rnd):
        nids = s.ring.node_ids()
        if rnd % 2 == 0 and rnd <= 80:
            s.inject(nids[int(rng.integers(len(nids)))],
                     ENQ if rng.random() < 0.5 else DEQ)
        if rnd == 15:
            s.request_leave(anchor_proc)
    sk.run_rounds(250, inject_fn=inject)
    check_sequential_consistency(sk)
    sk.check_dht_placement()
    assert anchor_proc not in set(sk.ring.proc[n] for n in sk.ring.node_ids())
    assert sk.pending_membership == 0


def test_join_moves_dht_data_to_new_owner():
    sk = Skueue(4, mode="queue", seed=31)
    nids = sk.ring.node_ids()
    for i in range(30):
        sk.inject(nids[i % len(nids)], ENQ)
    sk.run_rounds(120)
    sk.check_dht_placement()
    assert sum(len(s) for s in sk.store) == 30
    for _ in range(3):
        sk.request_join()
    sk.run_rounds(150)
    sk.check_dht_placement()  # data must have moved to the new owners
    assert sum(len(s) for s in sk.store) == 30
    nids = sk.ring.node_ids()
    for i in range(30):
        sk.inject(nids[(7 * i) % len(nids)], DEQ)
    sk.run_rounds(200)
    check_sequential_consistency(sk)


def test_many_simultaneous_joins():
    """Theorem 17 flavour: a burst of joins integrates in few update phases."""
    sk = Skueue(8, mode="queue", seed=37)

    def inject(s, rnd):
        if rnd == 5:
            for _ in range(8):
                s.request_join()
    sk.run_rounds(200, inject_fn=inject)
    assert sk.ring.size == 3 * 16
    assert sk.pending_membership == 0
    assert sk.update_phases <= 6


def test_checker_rejects_a_wrong_result():
    sk = Skueue(3, mode="queue", seed=1)
    nid = sk.ring.node_ids()[0]
    for k in (ENQ, ENQ, DEQ):
        sk.inject(nid, k)
    sk.run_rounds(40)
    check_sequential_consistency(sk)
    sk.requests[2].result = sk.requests[1].elem   # the second, not the first
    with pytest.raises(ConsistencyViolation, match="queue replay mismatch"):
        check_sequential_consistency(sk)


# ------------------------------------------- against the reference --------
def _drive(cls, mode, sched, churn, seed):
    """One run of ``cls`` (the port's or the reference's Skueue): random
    requests at random nodes, and per ``churn`` a JOIN and a LEAVE
    ("churn"), the anchor process's LEAVE ("anchor"), or three JOINs one
    of which becomes the leftmost node, so the anchor hands its state off
    ("handoff"; salt 1 places the joiners' labels so)."""
    n = 4 + seed
    sk = cls(n, mode=mode, seed=seed, salt=int(churn == "handoff"))
    rng = np.random.default_rng(seed + 100)
    anchor_pid = sk.ring.proc[sk.ring.anchor]
    leaver = anchor_pid if churn == "anchor" else (anchor_pid + 1) % n

    def membership(s):
        if churn == "handoff":
            for _ in range(3):
                s.request_join()
        elif churn != "none":
            s.request_join()
            s.request_leave(leaver)

    if sched == "sync":
        def inject(s, rnd):
            if rnd == 12:
                membership(s)
            if rnd <= 60 and rnd % 2 == 0:
                _inject_random(s, 3, 0.55, rng)
        sk.run_rounds(120, inject_fn=inject)
        while sk.pending_membership or sk.update_active:
            sk.run_rounds(1)
            assert sk.now < 5_000
    else:
        _inject_random(sk, 20, 0.55, rng)
        membership(sk)
        # run_async stops once every request is done: keep requests coming
        # until the membership change has completed as well
        for _ in range(20):
            assert sk.run_async(max_steps=400_000)
            if not (sk.pending_membership or sk.update_active):
                break
            _inject_random(sk, 10, 0.55, rng)
    checked = (check_sequential_consistency if cls is Skueue
               else ref_check)(sk)
    sk.check_dht_placement()
    recs = [(r.rid, r.kind, r.node, r.elem, r.t_issue, r.t_done, r.pos,
             r.order, r.result, r.done) for r in sk.requests]
    a = sk.anchor_state
    return {"records": recs, "total_msgs": sk.total_msgs,
            "stats_batch_max_runs": sk.stats_batch_max_runs,
            "anchor_state": (a.first, a.last, a.ticket),
            "anchor_id": sk.anchor_id, "order_counter": sk.order_counter,
            "update_phases": sk.update_phases,
            "pending_membership": sk.pending_membership,
            "checker": checked, "now": sk.now,
            "nodes": sk.ring.node_ids(), "proc": list(sk.ring.proc),
            "leaver": leaver}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("churn", ["none", "churn", "anchor", "handoff"])
@pytest.mark.parametrize("sched", ["sync", "async"])
@pytest.mark.parametrize("mode", ["queue", "stack"])
def test_records_equal_reference(mode, sched, churn, seed):
    port = _drive(Skueue, mode, sched, churn, seed)
    ref = _drive(RefSkueue, mode, sched, churn, seed)
    assert port["records"] == ref["records"]
    for k in port:
        assert port[k] == ref[k], k
    if churn != "none":
        assert port["update_phases"] > 0 and port["pending_membership"] == 0
    procs = {port["proc"][v] for v in port["nodes"]}
    if churn in ("churn", "anchor"):   # the leaver's nodes run elsewhere
        assert port["leaver"] not in procs
    if churn == "handoff":   # a joined process now emulates the anchor
        assert port["anchor_id"] == port["nodes"][0]
        assert port["proc"][port["anchor_id"]] >= 4 + seed
    if mode == "stack":
        assert port["checker"]["n_locally_paired"] > 0


@pytest.mark.parametrize("module", [
    "repro_torch.core.protocol", "repro_torch.core.consistency",
    "repro_torch.core.ldb", "repro_torch.core.priority",
    "repro_torch.core.seap", "repro_torch.data",
    "repro_torch.launch.paper_figs"])
def test_protocol_modules_load_no_jax(module):
    """A fresh interpreter that imports the module holds no ``jax`` and no
    module of the reference package."""
    root = Path(__file__).resolve().parents[1]
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          env={"PYTHONPATH": str(root / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_paper_figs_cli_prints_each_figure(capsys, monkeypatch):
    """``python -m repro_torch.launch.paper_figs``: one CSV row per
    (figure, n, x), the rows equal to the reference's functions' (fig. 4
    here; it is the quickest)."""
    from repro_torch.launch import paper_figs
    calls = []
    for name in ("fig2_queue", "fig3_stack"):
        monkeypatch.setattr(paper_figs, name,
                            lambda full, name=name: calls.append(name) or [])
    paper_figs.main([])
    rows = capsys.readouterr().out.strip().splitlines()
    assert rows[0] == "figure,n,x,avg_rounds_per_request,requests"
    assert calls == ["fig2_queue", "fig3_stack"]
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "ref_paper_figs",
        Path(__file__).resolve().parents[1] / "benchmarks" / "paper_figs.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    want = [f"{a},{b},{c},{d!r},{e}" for a, b, c, d, e in ref.fig4_rate()]
    assert rows[1:] == want and len(want) == 6
