"""CLI: ``python -m repro_torch.analysis --all``.

Counterpart of ``python -m repro.analysis``: runs every wavecheck rule
family at ``--shards`` shards of the reference's shape on ``--device``
(default ``cuda``; it raises where there is none) and prints (or writes)
the JSON report.  Exit status is 0 iff no rule was violated.
``--selftest`` runs the mutation self-test instead and fails unless >= 3
rule families, ``collective_budget`` and ``donation`` among them, catch
the deliberately broken discipline.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="wavecheck: invariant analyzer for the port's device "
                    "wave path")
    ap.add_argument("--all", action="store_true",
                    help="run every rule family (default)")
    ap.add_argument("--selftest", action="store_true",
                    help="run the mutation self-test instead")
    ap.add_argument("--device", default="cuda",
                    help="device of the programs (default cuda; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--shards", type=int, default=8,
                    help="shards of every program (default 8)")
    ap.add_argument("--json", metavar="PATH",
                    help="also write the JSON report to PATH")
    ap.add_argument("--skip-recompile", action="store_true",
                    help="skip the rebuild-guard family (fastest)")
    args = ap.parse_args(argv)

    from .report import to_json
    if args.selftest:
        from .selftest import run_selftest
        report = run_selftest(args.device, args.shards)
    else:
        from .runner import run_all
        report = run_all(device=args.device, n_shards=args.shards,
                         skip_recompile=args.skip_recompile)

    text = to_json(report)
    if args.json:
        with open(args.json, "w", encoding="utf-8") as fh:
            fh.write(text + "\n")
    print(text)
    ok = bool(report.get("passed"))
    if args.selftest:
        print(f"wavecheck selftest: {report['n_tripped']}/5 rule families "
              f"tripped ({', '.join(report['tripped_rules'])}; need >= "
              f"{report['required']} with collective_budget and donation) "
              f"-> {'OK' if ok else 'FAIL'}", file=sys.stderr)
    else:
        print(f"wavecheck: {report['n_violations']} violations across "
              f"{len(report['programs'])} programs on {report['device']} -> "
              f"{'OK' if ok else 'FAIL'}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
