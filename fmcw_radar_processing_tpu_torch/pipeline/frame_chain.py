"""The per-frame processing chain, batched over a whole recording.

The reference iterates frames serially (radar_processing.m:197-261); here
every stage is batched over the [F, PN, 2·NTS] recording. Two
formulations, chosen by ``impl`` as in the JAX package's
``make_frame_chain``:

  the profile chain ("auto", "pallas_profile", "pallas_profile_high"):
    1. profile [F, K]: kernel K1 (ops/fast_time_cuda.py) — range DFT, |·|
       and the max over chirps, without writing the range-FFT cube;
    2. peak search (dsp/detection.py);
    3. the detected bins' chirp rows, recomputed with a gathered-weight
       matmul (PackedFastTime.rf_at_bins), then a 16-point Doppler matmul
       at those bins only and the Doppler peak / measurements.
    K1 is exact float32, so one formulation serves both the production
    impl "pallas_profile_high" and the fidelity impl "pallas_profile".
    With ``return_range_fft`` these impls take the JAX package's plain
    branch instead: the cube by one matmul (PackedFastTime.rf), then
    range_profile and search_peaks.

  the materializing chain ("pallas"):
    1. range FFT [F, PN, K, 2] and profile: kernel K6
       (ops/fast_time_cuda.py::fast_time);
    2. peak search: kernel K7 (ops/detect_cuda.py);
    3. the Doppler rows and the strongest chirp gathered from the cube.

The JAX impls "fused", "xla", "fused_bf16" and "pallas_profile_bf16" are
not ported (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from fmcw_radar_processing_tpu.config import RadarConfig
from fmcw_radar_processing_tpu_torch.dsp.detection import DetectionResult, search_peaks
from fmcw_radar_processing_tpu_torch.dsp.fast_time import PackedFastTime, range_profile
from fmcw_radar_processing_tpu_torch.dsp.slow_time import (
    DopplerPeaks,
    SlowTimeOperator,
    doppler_at_bins,
    doppler_peaks_at,
    measurements,
)
from fmcw_radar_processing_tpu_torch.ops.detect_cuda import search_peaks_fused
from fmcw_radar_processing_tpu_torch.ops.fast_time_cuda import (
    blocked_weight,
    calib_offset,
    fast_time,
    fast_time_profile,
)
from fmcw_radar_processing_tpu_torch.utils.cplx import pair_matmul

PROFILE_IMPLS = ("pallas_profile", "pallas_profile_high")
UNPORTED_IMPLS = ("fused", "xla", "fused_bf16", "pallas_profile_bf16")


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
    range_fft: torch.Tensor | None = None  # [F, PN, K, 2] float32 pair, if
    # requested


def resolve_impl(impl: str) -> str:
    """The impl a chain runs: "auto" is the profile chain on every device
    (its CPU run takes the kernels' plain versions). Raises ValueError for
    an unknown impl and NotImplementedError for a JAX impl not ported."""
    if impl == "auto":
        impl = "pallas_profile_high"
    if impl in UNPORTED_IMPLS:
        raise NotImplementedError(
            f"impl {impl!r} is not ported to PyTorch (ROADMAP.md, Queue 1); "
            f"the port runs 'auto', 'pallas', 'pallas_profile' and "
            f"'pallas_profile_high'")
    if impl != "pallas" and impl not in PROFILE_IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    return impl


def make_frame_chain(
    cfg: RadarConfig, device: torch.device | str = "cpu",
    return_range_fft: bool = False, impl: str = "auto",
) -> Callable[[torch.Tensor, torch.Tensor], FrameChainOutputs]:
    """Build the recording chain for a fixed config on ``device``.

    Returns fn(raw [F, PN, 2·NTS] float32, calib [NTS, 2] float32) ->
    FrameChainOutputs, both inputs on ``device``. ``range_fft`` is the
    [F, PN, K, 2] cube when ``return_range_fft``, else None.
    """
    impl = resolve_impl(impl)
    pft = PackedFastTime.create(cfg, device)
    st = SlowTimeOperator.create(cfg, device)
    w_blocked = blocked_weight(cfg, device)
    pn, nts = cfg.pn, cfg.nts

    def chain(raw: torch.Tensor, calib: torch.Tensor) -> FrameChainOutputs:
        f = raw.shape[0]
        rf = None
        if impl == "pallas":
            x = raw.reshape(f * pn, 2 * nts)
            rf, profile = fast_time(x, w_blocked, calib_offset(calib, w_blocked),
                                    pn)  # [F, PN, K, 2], [F, K]
            det = search_peaks_fused(profile, cfg)  # [F, T]
        elif not return_range_fft:
            x = raw.reshape(f * pn, 2 * nts)
            profile = fast_time_profile(x, w_blocked,
                                        calib_offset(calib, w_blocked),
                                        pn)  # [F, K], rf never materialized
            det = search_peaks(profile, cfg)  # [F, T]
        else:
            rf = pft.rf(raw, calib)  # [F, PN, K, 2]
            profile = range_profile(rf)  # [F, K]
            det = search_peaks(profile, cfg)  # [F, T]
        # Doppler only at detected bins (radar_processing.m:216-219).
        if rf is None:
            rf_rows = pft.rf_at_bins(raw, calib, det.idx)  # [F, PN, T, 2]
            rows = rf_rows.transpose(-3, -2)  # [F, T, PN, 2]
            rd_rows = pair_matmul(rows, st.m_re_t, st.m_im_t,
                                  "...tp,dp->...td")  # [F, T, D, 2]
            strongest = rf_rows[:, :, 0, :]  # [F, PN, 2]
        else:
            rd_rows = doppler_at_bins(st, rf, det.idx)  # [F, T, D, 2]
            # Chirp row at the strongest detected bin, per frame (:258-259).
            at = det.idx[:, 0].to(torch.int64)[:, None, None, None]
            strongest = torch.gather(rf, 2, at.expand(f, pn, 1, 2))[:, :, 0]
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
            range_fft=rf if return_range_fft else None,
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
