"""The per-frame processing chain, batched over a whole recording.

The reference iterates frames serially (radar_processing.m:197-261); here
every stage is batched over the [F, PN, 2·NTS] recording:

  1. profile [F, K]: kernel K1 (ops/fast_time_cuda.py) — range DFT, |·| and
     the max over chirps, without writing the range-FFT cube;
  2. peak search (dsp/detection.py);
  3. the detected bins' chirp rows, recomputed with a gathered-weight
     matmul (PackedFastTime.rf_at_bins), then a 16-point Doppler matmul at
     those bins only and the Doppler peak / measurements.

This is the JAX package's production impl ``pallas_profile_high``; the
port keeps that one formulation (its kernel is exact float32, so it also
serves the fidelity impl ``pallas_profile``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from fmcw_radar_processing_tpu.config import RadarConfig
from fmcw_radar_processing_tpu_torch.dsp.detection import DetectionResult, search_peaks
from fmcw_radar_processing_tpu_torch.dsp.fast_time import PackedFastTime
from fmcw_radar_processing_tpu_torch.dsp.slow_time import (
    DopplerPeaks,
    SlowTimeOperator,
    doppler_peaks_at,
    measurements,
)
from fmcw_radar_processing_tpu_torch.ops.fast_time_cuda import (
    blocked_weight,
    calib_offset,
    fast_time_profile,
)
from fmcw_radar_processing_tpu_torch.utils.cplx import pair_matmul


class FrameChainOutputs(NamedTuple):
    """Per-frame chain results for a recording of F frames."""

    waterfall: torch.Tensor  # [F, K] float32 — abs-max over chirps (:265)
    detection: DetectionResult  # idx/magnitude/valid, each [F, T]
    doppler: DopplerPeaks  # doppler_idx/speed, each [F, T]
    strength: torch.Tensor  # [T, F] float32, NaN-filled
    range: torch.Tensor  # [T, F] float32, NaN-filled
    speed: torch.Tensor  # [T, F] float32, NaN-filled
    strongest_chirps: torch.Tensor  # [F, PN, 2] float32 pair — range FFT rows
    # at the strongest target's bin (radar_processing.m:258-259); garbage
    # where detected is False
    detected: torch.Tensor  # [F] bool


def make_frame_chain(
    cfg: RadarConfig, device: torch.device | str = "cpu",
) -> Callable[[torch.Tensor, torch.Tensor], FrameChainOutputs]:
    """Build the recording chain for a fixed config on ``device``.

    Returns fn(raw [F, PN, 2·NTS] float32, calib [NTS, 2] float32) ->
    FrameChainOutputs, both inputs on ``device``.
    """
    pft = PackedFastTime.create(cfg, device)
    st = SlowTimeOperator.create(cfg, device)
    w_blocked = blocked_weight(cfg, device)
    pn, nts = cfg.pn, cfg.nts

    def chain(raw: torch.Tensor, calib: torch.Tensor) -> FrameChainOutputs:
        f = raw.shape[0]
        x = raw.reshape(f * pn, 2 * nts)
        profile = fast_time_profile(x, w_blocked, calib_offset(calib, w_blocked),
                                    pn)  # [F, K], rf never materialized
        det = search_peaks(profile, cfg)  # [F, T]
        # Doppler only at detected bins (radar_processing.m:216-219).
        rf_rows = pft.rf_at_bins(raw, calib, det.idx)  # [F, PN, T, 2]
        rows = rf_rows.transpose(-3, -2)  # [F, T, PN, 2]
        rd_rows = pair_matmul(rows, st.m_re_t, st.m_im_t,
                              "...tp,dp->...td")  # [F, T, D, 2]
        strongest = rf_rows[:, :, 0, :]  # [F, PN, 2]
        dop = doppler_peaks_at(rd_rows, cfg)
        meas = measurements(det, dop, cfg)
        return FrameChainOutputs(
            waterfall=profile,
            detection=det,
            doppler=dop,
            strength=meas.strength,
            range=meas.range,
            speed=meas.speed,
            strongest_chirps=strongest,
            detected=det.valid[:, 0],
        )

    return chain


def pack_slow_time(strongest_chirps: torch.Tensor, detected: torch.Tensor,
                   pn: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Concatenate chirp rows of detected frames (radar_processing.m:255-260)
    into a fixed-capacity buffer.

    A stable partition: detected frames first, in frame order, whole chirp
    rows gathered, everything past the valid prefix zeroed.

    Returns (signal [F·PN, 2] float32 pair, valid_count 0-d int32 tensor).
    """
    f = strongest_chirps.shape[0]
    perm = torch.argsort((~detected).to(torch.int32), stable=True)
    gathered = strongest_chirps.to(torch.float32)[perm]
    n_det = detected.to(torch.int32).sum(dtype=torch.int32)
    keep = torch.arange(f, dtype=torch.int32, device=detected.device) < n_det
    out = torch.where(keep[:, None, None], gathered, 0.0)
    return out.reshape(f * pn, 2), n_det * pn
