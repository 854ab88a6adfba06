"""Reproduce the first-call precision loss of MKL's vector math library
(VML) on the CPU, and check the port's guard against it.

Each run is a fresh Python process on two torch threads that does one
threaded float32 GEMM (MKL) and then its first ``torch.sqrt`` on a
[192, 256] tensor (VML, split between the two threads). It compares the
square roots with float64 ones and reports the largest relative error
and the rows beyond 1e-6. Without the guard, on an Intel Xeon with
AVX-512 (torch 2.13, MKL 2024.2), one process in 20 to 40 returned rows
0-95, the calling thread's share, about 3.2e-4 off. With ``--settle``
each process first calls the port's ``utils.cplx.settle_cpu_math``.

    python tools/vml_first_call_probe.py [--runs 60] [--jobs 6] [--settle]

Prints one line per bad run and a summary; exits 1 if any run was bad.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ONE_RUN = """
import sys
import numpy as np
import torch
torch.set_num_threads(2)
if sys.argv[1] == "settle":
    from fmcw_radar_processing_tpu_torch.utils.cplx import settle_cpu_math
    settle_cpu_math()
torch.randn(192, 128) @ torch.randn(128, 512)
a = torch.as_tensor(
    (np.random.default_rng(0).random((192, 512)) * 3e4).astype(np.float32))
s = a[:, :256] * a[:, :256] + a[:, 256:] * a[:, 256:]
ref = np.sqrt(s.numpy().astype(np.float64))
rel = np.abs(torch.sqrt(s).numpy() - ref) / ref
rows = np.flatnonzero(rel.max(axis=1) > 1e-6)
print(f"{rel.max():.2e}", f"{rows.min()}-{rows.max()}" if len(rows) else "-")
"""


def one_run(settle: bool) -> tuple[float, str]:
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    out = subprocess.run([sys.executable, "-c", ONE_RUN, "settle" if settle else "raw"],
                         capture_output=True, text=True, env=env, check=True)
    err, rows = out.stdout.split()
    return float(err), rows


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=60)
    p.add_argument("--jobs", type=int, default=6)
    p.add_argument("--settle", action="store_true",
                   help="call settle_cpu_math first in each process")
    args = p.parse_args(argv)
    with ThreadPoolExecutor(args.jobs) as pool:
        results = list(pool.map(lambda _: one_run(args.settle), range(args.runs)))
    bad = [(e, r) for e, r in results if r != "-"]
    for e, r in bad:
        print(f"bad run: max relative error {e:.2e}, rows {r}")
    print(f"{len(bad)} of {args.runs} runs lost precision "
          f"({'settled' if args.settle else 'not settled'}; worst "
          f"{max(e for e, _ in results):.2e})")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
