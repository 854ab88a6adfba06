"""Time the port's JSON writer on the spectrogram payload of a 1,024-frame
upload at the service's default profile (the float32 dB map, 1,024 x
14,730, and its float64 axes), pretty as the service writes it.

Each round writes the payload once in each mode, in turn:

  * ``buffered``: ``dumps_matlab`` into one string, then a text-mode write
    (how ``write_json`` wrote before it streamed);
  * ``stream1``: ``write_json`` on one torch thread (the native stream, no
    workers);
  * ``streamN``: ``write_json`` on N torch threads (N formatting workers).

    python tools/json_write_probe.py [--rounds 5] [--threads 2] [--cols 14730]

Prints one JSON line per write (mode, round, seconds, bytes) and a last
line of each mode's median seconds; every file's bytes must be equal.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from fmcw_radar_processing_tpu_torch.utils import jsonio  # noqa: E402


def payload(cols: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    db = (rng.standard_normal((1024, cols)) * 12.0 - 95.0).astype(np.float32)
    return {"time": np.arange(cols) * (0.15 * 1024 / cols),
            "frequency": np.geomspace(1.0, 106666.67, 1024),
            "intensity": db, "title": "All Frames - Log-Scaled Spectrogram",
            "xLabel": "Time (s)", "yLabel": "Frequency (Hz)"}


def write_buffered(path: str, obj: dict) -> int:
    text = jsonio.dumps_matlab(obj, pretty=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return os.path.getsize(path)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--cols", type=int, default=14730)
    args = ap.parse_args()
    obj = payload(args.cols)
    jsonio._get_native()  # build outside the timed writes
    modes = {"buffered": (1, write_buffered), "stream1": (1, jsonio.write_json),
             f"stream{args.threads}": (args.threads, jsonio.write_json)}
    times: dict[str, list[float]] = {m: [] for m in modes}
    digests = set()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spectrogram_data.json")
        for r in range(args.rounds):
            order = list(modes) if r % 2 == 0 else list(reversed(modes))
            for mode in order:
                threads, write = modes[mode]
                torch.set_num_threads(threads)
                t0 = time.perf_counter()
                n = write(path, obj)
                dt = time.perf_counter() - t0
                with open(path, "rb") as f:
                    digests.add(hashlib.sha256(f.read()).hexdigest())
                os.remove(path)
                times[mode].append(dt)
                print(json.dumps({"mode": mode, "round": r, "seconds": dt,
                                  "bytes": n}), flush=True)
    print(json.dumps({"median_s": {m: statistics.median(v) for m, v in times.items()},
                      "identical": len(digests) == 1, "cpus": os.cpu_count()}))
    if len(digests) != 1:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
