"""Run one cell of the benchmark once and print its result line.

    python3 radarbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (where BENCHMARK.json is). Exits 2, printing
no result, without enough CUDA cards for the cell; exits 3 if a module of
JAX or of the JAX package is loaded once the window has closed. The last
line on stdout is the result's JSON object; the last lines on stderr give
each compared number beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    sys.path.insert(0, root)
    from radarbench import harness

    bench = harness.Bench(root)
    chips = bench.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(root, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    harness.report(result)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
