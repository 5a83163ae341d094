"""wavecheck in torch terms (``repro_torch.analysis``) on the CPU.

The counterparts of the reference's seven tests in
``tests/test_analysis.py``: ``run_all`` with zero violations at 8 shards
(35 programs; exactly 2 exchanges a step and a narrower step, 5 for the
seed wave, 1 a migration; a first bounce that rebuilt something and a
second that rebuilt nothing), the mutation self-test, the seam counter
(in place of the HLO parser), the AST lint, the int32 lint, the rebuild
tracker and an undeclared collective.  Then cross-checks against the JAX
package: the reference's program names and exact all-to-all budgets
(built, not compiled, at 8 forced devices), its ``lint_jaxpr`` verdicts
on its three small functions, and its ``doclint`` on the same files.
"""
import json
import os
import textwrap

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multidev import run_multidev

from repro_torch.analysis import (CollectiveBudget, RebuildTracker,
                                  check_budget, collective_counts,
                                  count_exchanges, lint_fn, lint_paths,
                                  run_all, run_selftest)
from repro_torch.analysis.astlint import lint_source
from repro_torch.analysis.overflow import check_int32_overflow
from repro_torch.dqueue import DeviceQueue, ElasticDeviceQueue
from repro_torch.runtime import LocalRuntime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INF = 2 ** 30


@pytest.fixture(scope="module")
def report():
    return run_all(device="cpu", n_shards=8)


# ---------------------------------------------------------------------------
# acceptance: the full analyzer on the port, 8 shards, zero violations
# ---------------------------------------------------------------------------
def test_run_all_zero_violations_8shards(report):
    assert report["tool"] == "wavecheck"
    assert report["passed"], report["violations"]
    assert report["n_violations"] == 0, report["violations"]
    progs = report["programs"]
    # 4 disciplines x (step, seq burst, pipelined burst, 2 telemetry twins,
    # 2 narrower-width twins at L = 2) + the seed wave + 2 runtime twins
    # + 4 migrations = 35, as the reference counts
    assert len(progs) == 35, sorted(progs)
    assert len([n for n in progs if "obs]" in n]) == 8
    assert len([n for n in progs if "compact:" in n]) == 8
    K = report["sizes"]["K"]
    for name, info in progs.items():
        c = info["collectives"]
        assert c["gather"] == 0, (name, c)     # one process: no gather
        if (name.endswith(".step") or ".step[" in name) \
                and "legacy" not in name:
            assert c["exchange"] == 2, (name, c)
        elif "run_waves[seq]" in name:
            assert c["exchange"] == 2 * K, (name, c)
        elif "run_waves[pipe" in name:
            assert c["exchange"] == K + 1, (name, c)
        if "migration" not in name:
            # the store tensors (and the ring's rows) held in place
            assert info["held"] == 2 + ("obs]" in name), (name, info)
    assert progs["queue-legacy.step"]["collectives"]["exchange"] == 5
    for kind in ("queue", "stack", "priority", "seap"):
        mig = progs[f"{kind}.migration"]
        assert mig["collectives"] == {"exchange": 1, "gather": 0}, mig
        assert mig["donated_leaves"] == 2 and mig["held"] == 0, mig
    rg = report["recompile_guard"]
    assert rg["warm_rebuilds"] > 0 and rg["second_bounce_rebuilds"] == 0, rg
    assert rg["warm"]["inner"] >= 1 and rg["warm"]["compiled"] == 0, rg
    assert report["torch_version"] == torch.__version__
    json.dumps(report)


def test_mutation_selftest_trips_at_least_three_rules():
    rep = run_selftest("cpu", 8)
    assert rep["passed"], rep
    assert rep["n_tripped"] >= 3, rep
    # the broken discipline itself (extra exchange + copied store) must be
    # caught, not just the idiom mutations
    assert "collective_budget" in rep["tripped_rules"], rep
    assert "donation" in rep["tripped_rules"], rep


def test_cli_all_and_selftest_exit_codes(tmp_path):
    from repro_torch.analysis.__main__ import main
    out = tmp_path / "wc.json"
    assert main(["--all", "--device", "cpu", "--shards", "4",
                 "--skip-recompile", "--json", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["passed"] and rep["n_shards"] == 4, rep["violations"]
    assert main(["--selftest", "--device", "cpu", "--shards", "4"]) == 0


# ---------------------------------------------------------------------------
# the seam counter (in place of the HLO parser)
# ---------------------------------------------------------------------------
def test_seam_counts_exchanges_and_gathers():
    rt = LocalRuntime(4, device="cpu")
    buf = torch.arange(4 * 4 * 3).view(4, 4, 3)
    with collective_counts(rt) as c:
        out = rt.exchange(buf)
        rt.exchange(out)
        rt.gather(buf)
    assert c.counts == {"exchange": 2, "gather": 1}
    assert c.launches == {}                 # the CPU runs no kernel
    assert torch.equal(out, buf.transpose(0, 1))

    n = 4 * 2
    ops = (torch.zeros(n, dtype=torch.bool), torch.ones(n, dtype=torch.bool),
           torch.zeros((n, 2), dtype=torch.int32))
    q = DeviceQueue(4, cap=8, payload_width=2, ops_per_shard=2,
                    device="cpu")
    assert count_exchanges(q.step, q.init_state(), *ops) == 2
    burst = tuple(x.expand(5, *x.shape) for x in ops)
    assert count_exchanges(q.run_waves, q.init_state(), *burst) == 6
    seed = DeviceQueue(4, cap=8, payload_width=2, ops_per_shard=2,
                       fused=False, device="cpu")
    assert count_exchanges(seed.step, seed.init_state(), *ops) == 5


def test_narrow_wave_programs_replay_on_the_cpu():
    # off the CPU, run_all replays the last call of each narrower-wave
    # program on the CPU from the same state and ops: the two must agree
    # bit for bit.  Here both sides run on the CPU, so they agree, and a
    # store written wrongly by the call is named
    from repro_torch.analysis.programs import build_programs
    specs = {s.name: s for s in build_programs(device="cpu")}
    replayed = sorted(n for n, s in specs.items() if s.replay)
    assert replayed == sorted(
        f"{k}.{p}[{m}compact:w1]" for k in ("queue", "stack", "priority",
                                            "seap")
        for p, m in (("step", ""), ("run_waves", "pipe,"))), replayed
    for name in replayed:
        spec = specs[name]
        for _ in range(2):
            args = spec.prepare()
            verify = spec.replay(args)
            spec.run(args)
            assert verify() == [], name
    spec = specs["queue.run_waves[pipe,compact:w1]"]
    args = spec.prepare()
    verify = spec.replay(args)
    spec.run(args)
    spec.stores()["store_vals"][0, 0, 0] += 1
    assert verify() == ["store_vals"]


# ---------------------------------------------------------------------------
# AST lint units (pure source handling)
# ---------------------------------------------------------------------------
def test_astlint_flags_device_scope_sins():
    bad = textwrap.dedent("""
        import torch
        class FifoDiscipline:
            def dispatch(self, carry, ops):
                k = int(ops[0].sum())
                n = int(ops[0].shape[0]) + len(ops)     # host values: fine
                assert k > 0
                print("occ", carry)
                return carry, ops[0].tolist()
            def run_waves(self, state, xs):
                while True:
                    torch.cuda.synchronize()
                    state = xs.sum().item()
                return state
    """)
    vs = lint_source(bad, "bad.py")
    checks = sorted(v.detail["check"] for v in vs)
    assert checks == ["no-bare-assert", "no-host-callback-in-wave",
                      "no-host-sync-in-wave", "no-host-sync-in-wave",
                      "no-sync-in-burst", "no-sync-in-burst"], checks

    # int() outside device scope stays legal (host-side code)
    ok = "def host(x):\n    return int(x) + 1\n"
    assert lint_source(ok, "ok.py") == []

    # the sanctioned Wavescope drain is exempt from the callback rule
    sanctioned = textwrap.dedent("""
        class WaveEngine:
            def _wave(self, state, ops):
                def drain_metrics(m):
                    return m.rows.cpu().numpy()
                return drain_metrics
    """)
    assert lint_source(sanctioned, "obs.py") == []

    # ... but any other host copy in a wave method is flagged, and so is
    # a helper the wave method calls
    smuggled = textwrap.dedent("""
        def helper(x):
            return x.cpu()
        class SeapDiscipline:
            def commit(self, store, recv):
                return helper(store)
    """)
    checks = {v.detail["check"] for v in lint_source(smuggled, "bad2.py")}
    assert checks == {"no-host-callback-in-wave"}, checks

    # direct device construction above the runtime seam
    direct = textwrap.dedent("""
        import torch
        def build(x):
            d = torch.device("cuda:0")
            torch.cuda.set_device(0)
            return x.cuda(), torch.cuda.device_count(), torch.device("cpu")
    """)
    vs = lint_source(direct, "serve/x.py", rules={"no-direct-device"})
    assert [v.detail["callee"] for v in vs] == [
        "torch.device", "torch.cuda.set_device", "x.cuda",
        "torch.cuda.device_count"], [str(v) for v in vs]

    # and the shipped wave-path modules are clean
    violations, info = lint_paths()
    assert violations == [], [str(v) for v in violations]
    assert any("wave_engine" in f for f in info["files_checked"])
    assert any(f.endswith("obs/device.py") for f in info["files_checked"])


# ---------------------------------------------------------------------------
# int32-overflow lint units
# ---------------------------------------------------------------------------
def _i32(*xs):
    return tuple(torch.tensor(x, dtype=torch.int32) for x in xs)


def test_overflow_lint_clean_on_guarded_and_trips_on_naive():
    lo, hi = _i32(-5, 7)
    assert lint_fn(lambda a, b: (a & b) + ((a ^ b) >> 1), (lo, hi),
                   program="mid", tainted_args=(0, 1)) == []
    vs = lint_fn(lambda a, b: (a + b) // 2, (lo, hi), program="mid",
                 tainted_args=(0, 1))
    assert vs and vs[0].rule == "int32_overflow", vs
    assert vs[0].detail["kind"] == "both-extreme-add"

    # INF growth is fine when the result feeds a clamp or a where
    assert lint_fn(lambda b: torch.clamp_max(b + INF, INF), (lo,),
                   program="clamped") == []
    assert lint_fn(lambda b: torch.where(b > 0, b + INF, 0), (lo,),
                   program="selected") == []
    vs = lint_fn(lambda b: (b + INF).reshape(1), (lo,), program="growth")
    assert [v.detail["kind"] for v in vs] == ["unclamped-extreme-add"]

    # a value-moving op's literals are indices, but a pad's fill and a
    # scatter's scalar are data: INF padded in and grown is caught
    vs = lint_fn(lambda b: F.pad(b[None], (1, 0), value=INF) + 1, (lo,),
                 program="padded")
    assert [v.detail["kind"] for v in vs] == ["unclamped-extreme-add"]
    vs = lint_fn(lambda b: torch.scatter(b[None], 0, torch.tensor([0]),
                                         INF) + 1, (lo,), program="scatter")
    assert [v.detail["kind"] for v in vs] == ["unclamped-extreme-add"]
    assert lint_fn(lambda b: F.pad(b[None], (1, 0))[:INF] + 1, (lo,),
                   program="index_literals") == []

    # the port's six scan_queue entries are clean, and the lint judged
    # arithmetic on extreme values in each entry that does any
    violations, info = check_int32_overflow()
    assert violations == [], [str(v) for v in violations]
    sites = {e["program"].split(":")[1]: e["tainted_sites"]
             for e in info["entries"]}
    assert len(sites) == 6, info
    # strict_batch_deletemin's inputs hold no extreme value, and
    # seap_bucket_lookup only compares and selects its keys: no site
    assert sites.pop("strict_batch_deletemin") == 0, info
    assert sites.pop("seap_bucket_lookup") == 0, info
    assert all(n > 0 for n in sites.values()), info


def test_overflow_lint_trips_on_a_mutated_scan_queue_entry(monkeypatch):
    # the FIFO scan's composition with the typo B1 + B2 for C1 + B2: two
    # INF-carrying operands, INF + INF = 2^31 wraps to INT32_MIN
    import repro_torch.core.scan_queue as sq

    def typo(t1, t2):
        (A1, B1, C1), (A2, B2, C2) = t1, t2
        return (A1 + A2,
                torch.clamp_max(torch.minimum(B1 + A2, B1 + B2), sq.INF),
                C1 + C2)
    inf = torch.tensor([sq.INF], dtype=torch.int32)
    assert int((inf + inf)[0]) == sq.INT32_MIN
    monkeypatch.setattr(sq._inclusive_scan, "__defaults__", (typo,))
    violations, _ = check_int32_overflow()
    hit = {(v.program, v.detail["kind"]) for v in violations}
    assert ("core/scan_queue.py:queue_scan", "both-extreme-add") in hit, hit


def test_int32_wrap_the_lint_guards_against():
    # what V1 stands for: the naive midpoint of two int32-edge keys wraps,
    # the blessed idiom the port's Seap split uses does not
    lo, hi = _i32(2 ** 31 - 3, 2 ** 31 - 1)
    assert int((lo + hi) // 2) < 0
    assert int((lo & hi) + ((lo ^ hi) >> 1)) == 2 ** 31 - 2


# ---------------------------------------------------------------------------
# the rebuild tracker, cold against warm
# ---------------------------------------------------------------------------
def test_rebuild_tracker_counts_only_fresh_builds():
    eq = ElasticDeviceQueue(2, cap=8, payload_width=1, ops_per_shard=2,
                            pool_size=3, device="cpu")
    with RebuildTracker(eq) as cold:
        eq.grow(1)                  # a new shard set builds its structure
        eq.shrink([2])
    assert cold.count == 1 and cold.inner == 1, cold.as_dict()
    with RebuildTracker(eq) as warm:
        eq.grow(1)                  # the same sets: cached
        eq.shrink([2])
    assert warm.count == 0, warm.as_dict()
    with RebuildTracker(eq) as busted:
        eq._inner_cache.clear()     # a rebuilt entry under an old key
        eq.grow(1)
        eq.shrink([2])
    assert busted.inner == 2, busted.as_dict()


def test_budget_check_reports_undeclared_collectives():
    counts = {"exchange": 2, "gather": 1}
    ok = CollectiveBudget(exact={"exchange": 2}, max={"gather": 4})
    assert check_budget("p", counts, ok) == []
    tight = CollectiveBudget(exact={"exchange": 1}, max={})
    vs = check_budget("p", counts, tight)
    assert len(vs) == 2, [str(v) for v in vs]
    assert {v.detail["collective"] for v in vs} == {"exchange", "gather"}
    assert "undeclared" in str(vs[1])


# ---------------------------------------------------------------------------
# cross-checks against the JAX package
# ---------------------------------------------------------------------------
REF_PROGRAMS = r"""
import json
from repro.compat import make_mesh
from repro.analysis.programs import build_programs, build_migration_programs
specs = build_programs(make_mesh((8,), ("data",))) + build_migration_programs()
print(json.dumps({s.name: s.budget.exact.get("all-to-all") for s in specs}))
"""


def test_program_names_and_budgets_match_reference(report):
    ref = json.loads(run_multidev(REF_PROGRAMS, n_dev=8).splitlines()[-1])
    progs = report["programs"]
    assert sorted(progs) == sorted(ref)
    for name, want in ref.items():
        if name.endswith(".step") or name.endswith(".migration") \
                or ".step[" in name:
            got = progs[name]["collectives"]["exchange"]
            assert got == want, (name, got, want)


def test_lint_fn_agrees_with_lint_jaxpr():
    import jax
    import jax.numpy as jnp

    from repro.analysis.overflow import lint_jaxpr
    sc = jax.ShapeDtypeStruct((), jnp.int32)
    J_INF = jnp.int32(INF)
    cases = [
        ("guarded_mid", lambda a, b: (a & b) + ((a ^ b) >> 1),
         lambda a, b: (a & b) + ((a ^ b) >> 1), 2, (0, 1)),
        ("naive_mid", lambda a, b: (a + b) // 2,
         lambda a, b: (a + b) // 2, 2, (0, 1)),
        ("clamped_inf", lambda b: jnp.minimum(b + J_INF, J_INF),
         lambda b: torch.clamp_max(b + INF, INF), 1, ()),
        ("padded_inf", lambda b: jnp.pad(b[None], (1, 0),
                                         constant_values=J_INF) + 1,
         lambda b: F.pad(b[None], (1, 0), value=INF) + 1, 1, ()),
    ]
    for name, jfn, tfn, n_args, tainted in cases:
        ref = lint_jaxpr(jfn, (sc,) * n_args, program=name,
                         tainted_args=tainted)
        got = lint_fn(tfn, _i32(*range(3, 3 + n_args)), program=name,
                      tainted_args=tainted)
        assert [v.detail["kind"] for v in got] == \
            [v.detail["kind"] for v in ref], (name, got, ref)


def test_doclint_agrees_with_reference(tmp_path):
    from pathlib import Path

    from repro.analysis import doclint as ref
    from repro_torch.analysis import doclint as port
    (tmp_path / "a.md").write_text(
        "# Top\n\n## Sub `x` *y*\n\n[ok](#sub-x-y) [bad](#nope) "
        "[file](b.md#missing) [gone](c.md) [web](https://x.org)\n")
    (tmp_path / "b.md").write_text("# B\n")
    cases = [([Path(ROOT) / "README.md"] + port.collect(
        [os.path.join(ROOT, "docs")]), Path(ROOT)),
        ([tmp_path / "a.md"], tmp_path)]
    for files, root in cases:
        assert port.check_links(files, root) == ref.check_links(files, root)
    assert len(port.check_links(*cases[1])) == 3
    assert port.check_links(*cases[0]) == []
    assert port.main([str(tmp_path / "a.md"), "--root", str(tmp_path)]) == 1
    for h in ("BENCH_PR*.json", "A `code` [link](x) heading!"):
        assert port.slugify(h) == ref.slugify(h)
    np.testing.assert_equal(sorted(port.anchors_of(tmp_path / "a.md")),
                            sorted(ref.anchors_of(tmp_path / "a.md")))


def test_port_lint_agrees_with_reference_lint_on_scan_queue(monkeypatch):
    # the reference's own test of its six entries fails under jax 0.9,
    # which names the nested-call primitive "jit" where its lint inlines
    # "pjit" only: its guard search stops at the call boundary.  With
    # "jit" inlined too (in this process; the file is untouched) the
    # reference's lint on the reference's six entries finds what the
    # port's lint finds on the port's six: nothing
    import repro.analysis.overflow as ref
    monkeypatch.setattr(ref, "_INLINE_PRIMS", ref._INLINE_PRIMS | {"jit"})
    ref_vs, ref_info = ref.check_int32_overflow()
    port_vs, port_info = check_int32_overflow()
    assert ref_vs == [] and port_vs == [], ([str(v) for v in ref_vs],
                                            [str(v) for v in port_vs])
    assert [e["program"] for e in ref_info["entries"]] == \
        [e["program"] for e in port_info["entries"]]
