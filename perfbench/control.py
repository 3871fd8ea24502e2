"""Readings that set a cell's limits: the numbers the check compares, for
the program (the lower reading) and for the control (the reference at the
precision below the configuration's, put in the program's place: the upper
reading), over several seeds in one process.

    python3 perfbench/control.py --workload <cell> --impl program|control \
        --seeds 11,12,13 [--seconds 5]

Prints one JSON line per seed: the seed, the impl, each number compared
and the check's readings.  Runs on the card; the benchmark's own runs do
not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--impl", choices=("program", "control"), required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness import core

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        r = core.run_cell(args.workload, seed, args.seconds, False,
                          impl=args.impl)
        print(json.dumps({
            "seed": seed, "impl": args.impl,
            "checks": {k: c["value"] for k, c in r["checks"].items()},
            "attempted": r["attempted"], "metrics": r["metrics"],
            "notes": r["_notes"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
