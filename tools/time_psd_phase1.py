"""Time the spectrogram export's phase-1 kernels of the PyTorch port at the
production recording's shape, on one CUDA card.

    PYTHONPATH=<checkout> python3 tools/time_psd_phase1.py [--reps N]

Input: a packed |slow-time| signal of 65,536 frames × 16 chirps, about 90%
valid (as ``chip_smoke.py`` builds it), STFT nfft 256: nb_pad 136 (8-aligned,
float32 dB store) and 144 (16-aligned, bf16 stores). Each wrapper that the
imported port has among ``psd_phase1`` (K2; K2b), ``psd_phase1_b3`` (K2a),
``psd_phase1_tiled`` (K4a), ``psd_tmax`` (K5a) and ``psd_tmax_tiled`` runs
in turns with the others and with a fill of a float32 map of the PSD's
size (the card's write rate for those bytes), CUDA events around each
call, twice in its turn; the medians of the first and of the second runs
are printed as one JSON line, with the card's name and power limit. The port is imported from
``PYTHONPATH``, so one call can time two checkouts of it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

FRAMES = 65_536
PN = 16
SEED = 20261016


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def time_turns(fns: dict, reps: int) -> dict:
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    runs = {name: ([], []) for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            for into in runs[name]:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                stop.record()
                stop.synchronize()
                into.append(start.elapsed_time(stop))
    return {name: [statistics.median(first), statistics.median(second)]
            for name, (first, second) in runs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=11)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_psd_phase1: needs a CUDA card", file=sys.stderr)
        return 2
    import fmcw_radar_processing_tpu_torch as port
    from fmcw_radar_processing_tpu_torch.dsp.stft import StftOperator
    from fmcw_radar_processing_tpu_torch.ops import stft_cuda as stc

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    present = rng.random(FRAMES) >= 0.10
    length = FRAMES * PN
    count = int(present.sum()) * PN
    sig_np = np.zeros(length, np.float32)
    sig_np[:count] = np.abs(rng.standard_normal(count)
                            + 4.0 * np.sin(np.arange(count) * 0.3))
    sig = torch.as_tensor(sig_np, device=dev)
    op = StftOperator.create(window_length=20, beta=3.0, nfft=256, fs=1.0)
    t_pad = -(-(length - 19) // stc.PSD_TILE) * stc.PSD_TILE
    nv = count - 19
    out = {"card": card_line(), "port": port.__file__, "reps": args.reps,
           "length": length, "valid_columns": nv, "t_pad": t_pad}
    names = [n for n in ("psd_phase1", "psd_phase1_b3", "psd_phase1_tiled",
                         "psd_tmax", "psd_tmax_tiled") if hasattr(stc, n)]
    for align in (8, 16):
        a2 = torch.as_tensor(stc._folded_operator(op, align), device=dev)
        nb_pad = a2.shape[0] // 2
        fns = {n: (lambda f=getattr(stc, n): f(sig, nv, a2, nb_pad, t_pad))
               for n in names}
        # The card's write rate for the same bytes: a fill of a
        # preallocated [nb_pad, t_pad] float32 map.
        fill_buf = torch.empty((nb_pad, t_pad), device=dev)
        fns["fill"] = lambda: fill_buf.fill_(1.0)
        out[f"nb_pad_{nb_pad}"] = time_turns(fns, args.reps)
        del fill_buf
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
