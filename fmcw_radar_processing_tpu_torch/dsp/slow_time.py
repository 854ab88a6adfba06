"""Slow-time (Doppler) processing and target speed extraction.

Per-bin mean removal across chirps, the Chebyshev window and the 16-point
fftshifted Doppler FFT (radar_processing.m:216-219) are all linear along
the chirp axis, so they fold into one PN→D complex matrix
(:func:`build_slow_time_matrix`), applied only at the detected range bins.
Peak extraction (radar_processing.m:227-239): argmax of |RD| over Doppler
bins; accepted iff ≥ Doppler_threshold and not the zero-velocity bin D//2,
else zero speed.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from fmcw_radar_processing_tpu.config import RadarConfig
from fmcw_radar_processing_tpu_torch.dsp.detection import DetectionResult
from fmcw_radar_processing_tpu_torch.dsp.windows import chebwin
from fmcw_radar_processing_tpu_torch.utils.cplx import pair_abs, pair_matmul


def build_slow_time_matrix(cfg: RadarConfig) -> np.ndarray:
    """A = S_shift · F_D · P · diag(2·chebwin(PN)) · (I − 11ᵀ/PN),  (D, PN).

    P handles MATLAB fft(x, D) length adaptation: truncation to the first D
    windowed chirps when PN > D, implicit zero-padding when PN < D.
    """
    pn = cfg.pn
    d = cfg.doppler_fft_size
    w = 2.0 * chebwin(pn)
    demean = np.eye(pn) - np.full((pn, pn), 1.0 / pn)
    # F_D · P: (D, PN) — column p contributes exp(-2πi p d / D) iff p < D.
    dd = np.arange(d)[:, None]
    pp = np.arange(pn)[None, :]
    fmat = np.where(pp < d, np.exp(-2j * np.pi * dd * pp / d), 0.0)
    a = fmat @ np.diag(w) @ demean
    # fftshift along the Doppler axis: output row i takes DFT row (i + D//2) % D.
    shift = (np.arange(d) + d // 2) % d
    return a[shift].astype(np.complex128)


@dataclasses.dataclass(frozen=True)
class SlowTimeOperator:
    """Fused Doppler operator; ``m_re``/``m_im`` (D, PN) float32 on host,
    ``m_re_t``/``m_im_t`` the same on ``device``."""

    m_re: np.ndarray
    m_im: np.ndarray
    m_re_t: torch.Tensor
    m_im_t: torch.Tensor

    @classmethod
    def create(cls, cfg: RadarConfig,
               device: torch.device | str = "cpu") -> "SlowTimeOperator":
        m = build_slow_time_matrix(cfg)
        m_re = m.real.astype(np.float32)
        m_im = m.imag.astype(np.float32)
        return cls(m_re=m_re, m_im=m_im,
                   m_re_t=torch.as_tensor(m_re, device=device),
                   m_im_t=torch.as_tensor(m_im, device=device))


def doppler_at_bins(op: SlowTimeOperator, range_fft: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """Doppler spectra at selected range bins only (radar_processing.m:216-219
    computes them at detected bins only): the PN chirp rows of each bin in
    ``idx`` gathered from the cube, then the 16-point Doppler matmul.

    range_fft: [..., PN, K, 2]; idx: [..., T] range-bin indices.
    Returns rd rows [..., T, D, 2].
    """
    *lead, pn, _, _ = range_fft.shape
    index = idx.to(torch.int64)[..., None, :, None].expand(
        *lead, pn, idx.shape[-1], 2)
    rows = torch.gather(range_fft, -2, index)  # [..., PN, T, 2]
    rows = rows.transpose(-3, -2)  # [..., T, PN, 2]
    return pair_matmul(rows, op.m_re_t, op.m_im_t, "...tp,dp->...td")


class DopplerPeaks(NamedTuple):
    doppler_idx: torch.Tensor  # [..., T] int32, 0-based fftshifted Doppler bin
    speed: torch.Tensor  # [..., T] float32 m/s (0 for rejected/zero-velocity)


def doppler_peaks_at(rd_rows: torch.Tensor, cfg: RadarConfig) -> DopplerPeaks:
    """Peak extraction from per-target Doppler rows [..., T, D, 2]."""
    zero_bin = cfg.zero_doppler_bin
    rows = pair_abs(rd_rows)  # [..., T, D]
    dop_idx = rows.argmax(dim=-1).to(torch.int32)
    val = rows.amax(dim=-1)
    accept = (val >= cfg.algorithm.doppler_threshold) & (dop_idx != zero_bin)
    dop_idx = torch.where(accept, dop_idx, zero_bin).to(torch.int32)
    # float32 constants as Python scalars: no host-to-device copy per call.
    step = float(np.float32(-cfg.derived.fd_per_bin * cfg.derived.hz_to_mps))
    speed = (dop_idx - zero_bin).to(torch.float32) * step
    return DopplerPeaks(doppler_idx=dop_idx, speed=speed)


class TargetMeasurements(NamedTuple):
    """Per-frame target track, (target, frame) layout, NaN where missing
    (the reference's 'yes'-branch convention, radar_processing.m:499-528)."""

    strength: torch.Tensor  # [T, F] float32
    range: torch.Tensor  # [T, F] float32 metres
    speed: torch.Tensor  # [T, F] float32 m/s


def measurements(detection: DetectionResult, peaks: DopplerPeaks,
                 cfg: RadarConfig) -> TargetMeasurements:
    """Assemble measurements from per-frame detections.

    detection/peaks have shape [F, T]; output tensors are [T, F].
    """
    nan = torch.nan
    dpb = float(np.float32(cfg.derived.dist_per_bin))
    strength = torch.where(detection.valid, detection.magnitude, nan).T
    rng = torch.where(detection.valid,
                      detection.idx.to(torch.float32) * dpb, nan).T
    speed = torch.where(detection.valid, peaks.speed, nan).T
    return TargetMeasurements(strength=strength, range=rng, speed=speed)
