"""The readings that the limits are set from: the compared numbers of a
cell over many seeds, for the program and for its control (the
configuration's lower-precision paths in the program's place), in one
process.

    python3 radarbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 2 [--variants program,control] [--out FILE]

Each run is a whole run of the cell (set-up, a short window, the
comparison) on the card; one JSON line per run is printed (and appended to
FILE): variant, seed, correct, and each number with its limit. The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--variants", default="program,control")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    root = os.getcwd()
    sys.path.insert(0, root)
    from radarbench import harness

    for variant in args.variants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            r = harness.run_cell(root, args.workload, seed, args.seconds, False,
                                 args.device, variant=variant)
            line = {"workload": args.workload, "variant": variant, "seed": seed,
                    "correct": r["correct"], "attempted": r["attempted"],
                    "seconds": time.perf_counter() - t0,
                    "readings": {k: c["value"] for k, c in r["checks"].items()},
                    "metrics": {k: m["value"] for k, m in r["metrics"].items()}}
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
