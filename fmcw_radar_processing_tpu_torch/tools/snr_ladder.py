"""Per-stage SNR ladder of the port against the float64 oracle.

    python -m fmcw_radar_processing_tpu_torch.tools.snr_ladder \
        [--device cuda|cpu] [--out snr_ladder_torch.json]

Runs a synthetic 256-frame recording (two targets, one with micro-Doppler)
through the port's chain and spectrogram at each ``matmul_precision``
("default", "high", "highest": the TPU's 1, 3 and 6 bf16 passes) and
measures SNR stage by stage against the f64 oracle (``tools/oracle.py``):

  1. slow_time   — packed complex slow-time signal (chain output)
  2. magnitude   — |slow_time| fed to the STFT
  3. psd_linear  — framed-matmul one-sided PSD (linear power)
  4. psd_db      — 20·log10(P/max) dB map, full + per-band
  5. intensity   — log-frequency-rescaled 1024-bin dB map, full + per-band

The dB-domain error is stratified by the oracle's level: the reference
renders clim [-40, 0] dB (radar_processing.m:344), and the full-map
figures are capped by float32 cancellation at spectral nulls, bins far
below anything displayed. Keys, rounding and bands are those of the
repository's TPU record, ``SNR_LADDER.json``, which this tool does not
write.

The chain is ``make_frame_chain(cfg, device)`` with impl "auto": on the
card, kernel K1a finds the peaks, and the detected bins' chirp rows
(``PackedFastTime.rf_at_bins``), the STFT product and the rescale take
the rung's precision. On the CPU every product is exact float32
(utils/cplx.py::precision_matmul), so the three rungs agree there.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from fmcw_radar_processing_tpu_torch.config import (
    AlgorithmConfig,
    RadarConfig,
    default_device_config,
)
from fmcw_radar_processing_tpu_torch.dsp.stft import (
    DB_FLOOR,
    StftOperator,
    log_frequency_rescale,
    psd_db,
)
from fmcw_radar_processing_tpu_torch.io.synth import (
    SyntheticTarget,
    synthesize_recording,
)
from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import (
    make_frame_chain,
    pack_slow_time,
)
from fmcw_radar_processing_tpu_torch.tools.oracle import (
    log_rescale_oracle,
    process_recording_oracle,
    psd_db_oracle,
    spectrogram_oracle,
)
from fmcw_radar_processing_tpu_torch.utils.cplx import (
    MXU_PASSES,
    from_pair,
    pair_abs,
    resolve_device,
    to_pair,
)

PRECISIONS = tuple(MXU_PASSES)  # "default", "high", "highest"


def snr_db(got, want, mask=None) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if mask is not None:
        got, want = got[mask], want[mask]
    if got.size == 0:
        return float("nan")
    err = np.linalg.norm(got - want)
    ref = np.linalg.norm(want)
    if err == 0.0:
        return float("inf")
    return float(-20.0 * np.log10(err / max(ref, 1e-300)))


def _band(got: np.ndarray, ref: np.ndarray, m: np.ndarray) -> dict:
    return {
        "snr_db": round(snr_db(got, ref, m), 1),
        "max_abs_err_db": round(float(np.max(np.abs(got - ref)[m]))
                                if m.any() else float("nan"), 3),
        "fraction_of_bins": round(float(np.mean(m)), 4),
    }


def build_ladder(frames: int = 256, nfft: int = 256, seed: int = 0,
                 precision: str = "highest",
                 device: torch.device | str = "cuda") -> dict:
    """One rung of the ladder: the port's stages at ``precision`` against
    the f64 oracle, on ``device`` (the card unless the caller asks for
    "cpu"; "cuda" without a card raises RuntimeError)."""
    device = resolve_device(device)
    cfg = RadarConfig.create(
        default_device_config(),
        AlgorithmConfig(stft_nfft=nfft, matmul_precision=precision),
    )
    rec = synthesize_recording(
        cfg, frames,
        (SyntheticTarget(range_m=7.5, doppler_bin_offset=3,
                         md_phase_rad=1.0, md_rate_hz=40.0),
         SyntheticTarget(range_m=16.9, doppler_bin_offset=-2, amplitude=2.5)),
        seed=seed,
    )
    raw = torch.as_tensor(to_pair(rec.rx1()).reshape(frames, cfg.pn, -1),
                          device=device)
    calib = torch.as_tensor(to_pair(rec.calib_vector(0, cfg.nts)),
                            device=device)

    # ---- the port's float32 pipeline ----
    chain = make_frame_chain(cfg, device)
    op = StftOperator.create(
        window_length=cfg.algorithm.stft_window_length,
        beta=cfg.algorithm.stft_kaiser_beta, nfft=nfft,
        fs=1.0 / cfg.derived.prt, hop=1, precision=precision,
    )
    out = chain(raw, calib)
    sig, count_dev = pack_slow_time(out.strongest_chirps, out.detected, cfg.pn)
    count = int(count_dev)
    res = op(pair_abs(sig), valid_len=count_dev)
    db = psd_db(res.power)
    freqs = res.freqs.cpu().numpy()
    _, intensity = log_frequency_rescale(freqs, db, cfg.algorithm.max_freq_bins,
                                         precision=precision)
    ncols = count - cfg.algorithm.stft_window_length + 1
    mag = pair_abs(sig)[:count].cpu().numpy()
    slow_c = from_pair(sig[:count])
    p32 = res.power[:, :ncols].cpu().numpy()
    db32 = db[:, :ncols].cpu().numpy()
    int32 = intensity[:, :ncols].cpu().numpy()

    # ---- f64 oracle ----
    raw_matlab = np.swapaxes(rec.rx1()[:frames], -1, -2)
    want = process_recording_oracle(raw_matlab, rec.calib_vector(0, cfg.nts),
                                    cfg)
    iq64 = np.abs(want.slow_time_signal)
    freqs64, _, p64 = spectrogram_oracle(iq64, 1.0 / cfg.derived.prt, nfft=nfft)
    db64 = psd_db_oracle(p64)
    _, int64 = log_rescale_oracle(freqs64, db64)
    db64f = np.maximum(db64, DB_FLOOR)
    int64f = np.maximum(int64, DB_FLOOR)

    assert count == len(iq64), (count, len(iq64))
    assert p32.shape == p64.shape

    # ---- the ladder ----
    ladder: dict[str, object] = {
        "frames": frames, "nfft": nfft,
        "device_kind": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "matmul_precision": precision,
        "stft_columns": int(p32.shape[1]),
        "1_slow_time_snr_db": round(snr_db(
            np.stack([slow_c.real, slow_c.imag]),
            np.stack([want.slow_time_signal.real,
                      want.slow_time_signal.imag])), 1),
        "2_magnitude_snr_db": round(snr_db(mag, iq64), 1),
        "3_psd_linear_snr_db": round(snr_db(p32, p64), 1),
        "4_psd_db_full_snr_db": round(snr_db(db32, db64f), 1),
        "5_intensity_full_snr_db": round(snr_db(int32, int64f), 1),
    }

    # dB-domain error stratified by the ORACLE's level (the clim band is
    # what the reference's PNG displays).
    for name, got, ref in (("psd_db", db32, db64f),
                           ("intensity", int32, int64f)):
        bands = {label: _band(got, ref, ref >= lo)
                 for lo, label in ((-40.0, "display_band_ge_-40dB"),
                                   (-80.0, "ge_-80dB"),
                                   (-120.0, "ge_-120dB"))}
        bands["floor_lt_-120dB"] = _band(got, ref, ref < -120.0)
        ladder[f"{name}_bands"] = bands

    # Relative linear-power error stratified the same way: the float32
    # cancellation at nulls, where the absolute power vanishes.
    rel = np.abs(p32 - p64) / np.maximum(p64, 1e-300)
    strata = {}
    for lo, label in ((-40.0, "ge_-40dB"), (-80.0, "ge_-80dB"),
                      (-120.0, "ge_-120dB")):
        m = db64f >= lo
        strata[label] = round(float(np.median(rel[m])) if m.any() else
                              float("nan"), 9)
    m = db64f < -120.0
    strata["floor_lt_-120dB"] = round(float(np.median(rel[m])) if m.any()
                                      else float("nan"), 6)
    ladder["psd_linear_median_rel_err_by_band"] = strata
    return ladder


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Per-stage SNR of the port against the f64 oracle, one "
                    "rung per matmul_precision.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--out", default="snr_ladder_torch.json",
                    help="where to write the JSON (default %(default)s)")
    args = ap.parse_args(argv)
    out = {p: build_ladder(precision=p, device=args.device) for p in PRECISIONS}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
