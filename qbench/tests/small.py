"""A copy of the benchmark's data at a size the CPU runs in seconds.

``small_root(tmp)`` copies ``BENCHMARK.json`` and the configurations,
mixes, adapters and readers under a temporary root, and cuts every
configuration to 8 shards of 64 ops and every mix to bursts of 4 waves
(a LEAVE of shards 6-7 and a JOIN of 2 in place of 48-63 and 16).  It
adds two cells that ``BENCHMARK.json`` does not list, as data files and
entries only: ``fifo_64x64k.sparse`` (12 valid ops a shard a wave, at the
narrowest ladder width that holds them) and ``fifo_64x64k.pushpop``
(enqueue-only and dequeue-only waves by turns).  The harness's own
modules and the plain models are the package's.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DATA = ("configs", "traffic", "structures", "end_to_end", "metrics")
SMALL = {"n_shards": 8, "pool_size": 8, "ops_per_shard": 64}
# cells made of data alone, which BENCHMARK.json does not list
EXTRA_MIXES = {
    "sparse": {"waves_per_burst": 4, "enq_share": 0.5,
               "valid_per_shard": 12, "judge_share": 0.5,
               "profile_bursts": 2},
    "pushpop": {"waves_per_burst": 4, "enq_share": [1.0, 0.0],
                "judge_share": 0.5, "profile_bursts": 2},
}
EXTRA_CELLS = tuple(f"fifo_64x64k.{m}" for m in EXTRA_MIXES)


def small_root(tmp: Path) -> Path:
    """The benchmark's files under ``tmp``, cut to the CPU's size."""
    tmp = Path(tmp)
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for d in DATA:
        shutil.copytree(ROOT / "qbench" / d, tmp / "qbench" / d)
    for f in (tmp / "qbench" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg.update(SMALL)
        cfg["cap"] = 512 if cfg["structure"] == "fifo" else 256
        cfg["backlog"] = cfg["cap"] * 8 // 4
        f.write_text(json.dumps(cfg))
    for f in (tmp / "qbench" / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        mix["waves_per_burst"] = 4
        if "resize" in mix:
            mix["resize"]["steps"] = [{"leave": [6, 8]}, {"join": 2}]
        f.write_text(json.dumps(mix))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    for mix, params in EXTRA_MIXES.items():
        (tmp / "qbench" / "traffic" / f"{mix}.json").write_text(
            json.dumps(params))
        bench["workloads"].append({"name": f"fifo_64x64k.{mix}",
                                   "config": "fifo_64x64k", "traffic": mix,
                                   "chips": 1, "why": "data alone"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
