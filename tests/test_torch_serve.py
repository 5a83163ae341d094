"""The port's FIFO ServeEngine against the JAX package's, on the same
parameters.

``mamba2_130m.reduced(n_layers=2)`` as ``tests/test_serve_engine.py``
builds it; JAX's ``init_params(jax.random.key(0))`` crosses to the port
bit for bit.  Each scenario runs on both engines.  Admission does not
depend on token values (a request leaves after ``max_new`` tokens), so
served ids, every ``start_step`` and each step's slot assignment must be
identical.  Tokens must be identical wherever the JAX top-2 logit margin
exceeds ``MARGIN_TOL`` = 0.05: the two packages' decode logits differ by
up to about 0.02 in bf16 (``tests/test_torch_models.py``), so a nearer
tie may break either way; after the first such step the test stops
comparing tokens.  The 4 -> 2 shard resize runs the JAX engine in a
subprocess with four forced CPU devices.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
from multidev import run_multidev
from repro.configs import get_config as j_get_config
from repro.launch.mesh import make_host_mesh
from repro.models import build_model as j_build_model
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine

from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine

MARGIN_TOL = 0.05
SLOTS, MAX_SEQ = 3, 24


def _jax_side():
    cfg = j_get_config("mamba2_130m").reduced(n_layers=2)
    model = j_build_model(cfg)
    params, _ = model.init_params(jax.random.key(0))
    return cfg, model, params


@pytest.fixture(scope="module")
def models():
    cfg, jm, jp = _jax_side()
    tm = build_model(get_config("mamba2_130m").reduced(n_layers=2))
    return cfg, jm, jp, tm, params_from_jax(jp, "cpu")


def _trace_jax(eng):
    """Per decode: (step, slot rids, argmax per row, top-2 margin per
    row) from the JAX engine's vmapped decode."""
    log, orig = [], eng._decode

    def dec(p, c, t, i):
        lg, nc = orig(p, c, t, i)
        x = np.asarray(lg, np.float32)
        top2 = np.sort(x, -1)[:, -2:]
        log.append([eng.step_no, list(eng.slots), x.argmax(-1).tolist(),
                    (top2[:, 1] - top2[:, 0]).tolist()])
        return lg, nc
    eng._decode = dec
    return log


def _trace_port(eng):
    log, model = [], eng.model

    class Traced:
        cfg = model.cfg

        def decode_fn(self, p, c, t, i):
            lg, c = model.decode_fn(p, c, t, i)
            log.append([eng.step_no, list(eng.slots),
                        lg.argmax(-1).tolist()])
            return lg, c
    eng.model = Traced()
    return log


def _compare(jreqs, treqs, jlog, tlog):
    assert [r.rid for r in jreqs] == [r.rid for r in treqs]
    assert [r.start_step for r in treqs] == [r.start_step for r in jreqs]
    assert [r.finish_step for r in treqs] == [r.finish_step for r in jreqs]
    assert all(r.done for r in treqs)
    assert [e[:2] for e in tlog] == [e[:2] for e in jlog]
    for (_, slots, ja, margin), (_, _, ta) in zip(jlog, tlog):
        for i, rid in enumerate(slots):
            if rid is not None and ja[i] != ta[i]:
                assert margin[i] < MARGIN_TOL, (rid, margin[i])
                return
    assert [r.out for r in treqs] == [r.out for r in jreqs]


def _engines(models, n_shards=1, **kw):
    cfg, jm, jp, tm, tp = models
    je = JServeEngine(jm, jp, make_host_mesh(n_data=n_shards),
                      max_slots=SLOTS, max_seq=MAX_SEQ, **kw)
    te = ServeEngine(tm, tp, n_shards, max_slots=SLOTS, max_seq=MAX_SEQ,
                     device="cpu", **kw)
    return (je, _trace_jax(je)), (te, _trace_port(te))


def _run_both(models, scenario, **kw):
    (je, jlog), (te, tlog) = _engines(models, **kw)
    jreqs = scenario(je, JRequest)
    treqs = scenario(te, Request)
    _compare(jreqs, treqs, jlog, tlog)
    assert te.metrics() == je.metrics()
    return jreqs, treqs, je, te


def test_serves_all_requests_like_jax(models):
    vocab = models[0].vocab

    def scenario(eng, R):
        rng = np.random.default_rng(0)
        reqs = [R(rid=i, prompt=[int(t) for t in rng.integers(0, vocab, 3)],
                  max_new=4) for i in range(7)]
        eng.submit(reqs)
        assert eng.run_until_drained(max_steps=300)
        return reqs
    _, treqs, _, te = _run_both(models, scenario)
    assert te.stats["served"] == 7
    assert all(len(r.out) == 4 for r in treqs)


def test_fifo_admission_like_jax(models):
    def scenario(eng, R):
        first = [R(rid=100 + i, prompt=[1, 2], max_new=2) for i in range(4)]
        second = [R(rid=110 + i, prompt=[3, 4], max_new=2) for i in range(4)]
        eng.submit(first)
        eng.step()
        eng.submit(second)
        assert eng.run_until_drained(max_steps=300)
        return first + second
    _, treqs, _, _ = _run_both(models, scenario)
    assert max(r.start_step for r in treqs[:4]) <= min(
        r.start_step for r in treqs[4:])


def test_oversized_submit_chunks_like_jax(models):
    """A burst of 2 x (n_shards * L) + 3 requests chunks across waves (a
    power-of-two wave count) and is served completely, in FIFO order."""
    def scenario(eng, R):
        n_wave = eng.queue.n_shards * eng.queue.L
        reqs = [R(rid=500 + i, prompt=[1, 2], max_new=2)
                for i in range(2 * n_wave + 3)]
        eng.submit(reqs)
        assert eng.run_until_drained(max_steps=600)
        return reqs
    _, treqs, _, _ = _run_both(models, scenario)
    starts = [r.start_step for r in treqs]
    assert starts == sorted(starts)


def test_resize_under_staged_submissions_like_jax(models):
    def scenario(eng, R):
        first = [R(rid=i, prompt=[1, 2], max_new=2) for i in range(3)]
        eng.submit(first)
        eng.step()
        staged = [R(rid=100 + i, prompt=[3], max_new=2) for i in range(4)]
        eng.submit(staged)
        assert eng.resize(1)["P_to"] == 1
        assert eng.run_until_drained(max_steps=300)
        return first + staged
    _, treqs, _, te = _run_both(models, scenario)
    assert te.stats["served"] == 7
    starts = [r.start_step for r in treqs[3:]]
    assert starts == sorted(starts)


def _resize_scenario(eng, R, vocab):
    """Four shards, two steps, five more staged, a LEAVE to two shards with
    eight requests queued, then drain."""
    rng = np.random.default_rng(4)

    def req(rid):
        return R(rid=rid, prompt=[int(t) for t in rng.integers(0, vocab, 3)],
                 max_new=3)
    first = [req(i) for i in range(6)]
    eng.submit(first)
    eng.step()
    eng.step()
    staged = [req(100 + i) for i in range(5)]
    eng.submit(staged)
    mig = eng.resize(2)
    assert eng.run_until_drained(max_steps=300)
    return first + staged, {k: mig[k] for k in ("P_from", "P_to", "moved")}


def jax_resize_run() -> dict:
    """The JAX engine's side of the 4 -> 2 resize (run in a process with
    four CPU devices)."""
    cfg, jm, jp = _jax_side()
    eng = JServeEngine(jm, jp, make_host_mesh(n_data=4), max_slots=SLOTS,
                       max_seq=MAX_SEQ)
    log = _trace_jax(eng)
    reqs, mig = _resize_scenario(eng, JRequest, cfg.vocab)
    return {"reqs": [[r.rid, r.start_step, r.finish_step, r.out]
                     for r in reqs], "mig": mig, "log": log}


def test_resize_four_to_two_shards_like_jax(models):
    here = os.path.dirname(os.path.abspath(__file__))
    out = run_multidev(
        "import json, sys\n"
        f"sys.path.insert(0, {here!r})\n"
        "from test_torch_serve import jax_resize_run\n"
        "print('RESULT ' + json.dumps(jax_resize_run()))\n", n_dev=4)
    j = json.loads(out.split("RESULT ", 1)[1])
    te = ServeEngine(models[3], models[4], 4, max_slots=SLOTS,
                     max_seq=MAX_SEQ, device="cpu")
    tlog = _trace_port(te)
    treqs, mig = _resize_scenario(te, Request, models[0].vocab)
    assert mig == j["mig"] and mig["P_to"] == 2 and mig["moved"] == 8
    jreqs = [JRequest(rid=rid, prompt=[], start_step=s, finish_step=f,
                      out=out) for rid, s, f, out in j["reqs"]]
    _compare(jreqs, treqs, j["log"], tlog)
    starts = [r.start_step for r in treqs]
    assert starts == sorted(starts), "FIFO admission across the resize"


def test_engine_defaults_to_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(models[3], models[4], 1)
