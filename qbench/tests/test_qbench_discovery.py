"""The harness finds a configuration, a mix and a per-layer metric that
arrive as new files and new entries, with no file that is there edited;
and the run's guards: no card, no program, no JAX."""
import ast
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from qbench import harness
from qbench.tests.small import ROOT, small_root


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()
                                                     ).hexdigest()
            for p in sorted((root / "qbench").rglob("*")) if p.is_file()}


def test_new_files_and_entries_are_found(tmp_path):
    root = small_root(tmp_path)
    before = _digests(root)
    q = root / "qbench"
    cfg = json.loads((q / "configs" / "fifo_64x64k.json").read_text())
    cfg.update(name="fifo_wide", payload_width=6, backlog=600)
    (q / "configs" / "fifo_wide.json").write_text(json.dumps(cfg))
    mix = json.loads((q / "traffic" / "bulk.json").read_text())
    mix.update(enq_share=0.4, waves_per_burst=2)
    (q / "traffic" / "drain40.json").write_text(json.dumps(mix))
    (q / "metrics" / "judged_share.py").write_text(
        "def read(run):\n"
        "    return 100.0 * sum(b.judged for b in run.bursts) "
        "/ len(run.bursts)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "fifo_wide", "source": "a test",
                             "file": "qbench/configs/fifo_wide.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "fifo_wide.drain40",
                               "config": "fifo_wide", "traffic": "drain40",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "judged_share", "unit": "%",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "entry point",
                               "moves": "ops_per_s",
                               "workloads": ["fifo_wide.drain40"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = harness.run_cell(root, "fifo_wide.drain40", 5, 0.2, True,
                         device="cpu")
    assert r["correct"], r["checks"]
    # the metrics that name this cell: only the new one
    assert set(r["metrics"]) == {"judged_share"}
    assert 0 < r["metrics"]["judged_share"]["value"] <= 100
    r = harness.run_cell(root, "fifo_wide.drain40", 5, 0.2, False,
                         device="cpu")
    assert set(r["metrics"]) == {"ops_per_s", "latency_p95_ms", "setup_s"}
    after = _digests(root)
    assert {k: after[k] for k in before} == before


def test_metrics_of_follows_the_workloads_keys():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {w["name"] for w in bench["workloads"]}
    for cell in names:
        e2e = {m["name"] for m in harness.metrics_of(bench, cell, False)}
        assert {"setup_s", "ops_per_s", "latency_p95_ms"} <= e2e
        assert ("resize_p95_ms" in e2e) == cell.endswith(".churn")
        per = harness.metrics_of(bench, cell, True)
        assert per and all(m["moves"] in e2e for m in per)
    for m in bench["per_layer"] + bench["end_to_end"]:
        kind = "metrics" if m in bench["per_layer"] else "end_to_end"
        assert (ROOT / "qbench" / kind / f"{m['name']}.py").exists()


def test_percentile_is_nearest_rank():
    one = [(v, 1) for v in range(1, 101)]
    assert harness.percentile(one, 0.95) == 95
    assert harness.percentile(one, 1.0) == 100
    # the 19th of 20 ops
    assert harness.percentile([(1, 19), (2, 1)], 0.95) == 1
    assert harness.percentile([(2, 2), (1, 18)], 0.95) == 2
    # counts weigh: 900 ops at 3 ms, 100 at 7, 1 at 9 (ranks 891, 901,
    # 951 and 1,001 of 1,001)
    mix = [(7, 100), (9, 1), (3, 900)]
    assert harness.percentile(mix, 0.89) == 3
    assert harness.percentile(mix, 0.9) == 7
    assert harness.percentile(mix, 0.95) == 7
    assert harness.percentile(mix, 1.0) == 9
    assert harness.percentile([(5, 1)], 0.5) == 5


def test_the_mix_sets_the_shape_of_its_bursts(tmp_path):
    """A mix's ``valid_per_shard`` picks the ladder's width and
    ``enq_share`` as a list sets each wave's share."""
    from qbench.generator import OpStream
    import torch
    s = OpStream(3, "cpu", 4, lambda *a: {}, {})
    b = s.burst("window", 8, 16, 4, [1.0, 0.0], per_shard=12)
    assert b.n_ops == 4 * 8 * 12 and b.n == 8 * 16
    rows = b.valid.view(4, 8, 16)
    assert rows[..., :12].all() and not rows[..., 12:].any()
    assert b.is_enq[0::2].all() and not b.is_enq[1::2].any()
    again = OpStream(3, "cpu", 4, lambda *a: {}, {})
    r = again.burst("window", **b.spec)
    assert torch.equal(r.is_enq, b.is_enq) and torch.equal(r.valid, b.valid)
    root = small_root(tmp_path)
    bench, cell, cfg, traffic, adapter = harness.load_cell(
        root, "fifo_64x64k.sparse")
    q = adapter.build(cfg, torch.device("cpu"))
    drv = harness.Driver(q, adapter, OpStream(1, "cpu", 4, adapter.draw_extra,
                                              cfg), cfg, traffic,
                         torch.device("cpu"))
    assert drv.width() == 16 == q.pick_width(8 * 12)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_imports_jax_or_the_jax_package():
    files = list((ROOT / "qbench").rglob("*.py"))
    for f in files:
        assert not _imports(f) & set(harness.FORBIDDEN), f
        if "reference" in f.parts:
            assert "repro_torch" not in _imports(f), f


def _run_py(cwd: Path, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "qbench/run.py", "--workload", "fifo_64x64k.bulk",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_run_refuses_without_a_card():
    p = _run_py(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_run_refuses_without_the_program(tmp_path):
    (tmp_path / "qbench").mkdir()
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "qbench" / "run.py").write_text(
        (ROOT / "qbench" / "run.py").read_text())
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "repro", "repro.core",
                                  "flax", "benchmarks"])
def test_forbidden_modules_compare_top_level_names(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, "repro_torch_x", object())
    found = harness.forbidden_modules()
    assert name.split(".")[0] in found and "repro_torch_x" not in found
