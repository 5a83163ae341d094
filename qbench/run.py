"""Run one cell of ``BENCHMARK.json`` once on the card this process finds.

    python3 qbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; its last key,
``checks``, holds each number compared with the plain model beside its
limit, as do the last lines of standard error.  Exits with another code
than 0, and prints no result, where there is no CUDA device or fewer
than the cell needs, where the program under test is not in the
checkout, and where JAX, Flax, the JAX package or its benchmarks were
loaded by the time the window closed.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print("qbench: the program under test (src/repro_torch) is not in "
              f"this checkout ({ROOT})", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from qbench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"qbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("qbench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < chips[args.workload]:
        print(f"qbench: {args.workload} needs {chips[args.workload]} "
              f"devices, {torch.cuda.device_count()} found", file=sys.stderr)
        return 3

    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_process=T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print(f"qbench: loaded by the end of the window: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
