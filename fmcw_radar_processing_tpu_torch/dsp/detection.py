"""Range target detection: vectorized peak search.

Same semantics as the JAX package's ``dsp/detection.py`` (the reference's
external ``f_search_peak``, radar_processing.m:211): a bin is a peak if it
is a local maximum of the profile (≥ both neighbours), lies in
[min_distance, max_distance] and exceeds range_threshold; up to
``max_num_targets`` peaks are returned strongest first, in fixed-capacity
[..., T] arrays with a validity mask. Ties resolve to the LOWER bin, as
``jnp.argmax`` and ``jax.lax.top_k`` do.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from fmcw_radar_processing_tpu.config import RadarConfig


class DetectionResult(NamedTuple):
    idx: torch.Tensor  # [..., T] int32 — 0-based range-bin indices, strongest first
    magnitude: torch.Tensor  # [..., T] float32 — profile value at each peak
    valid: torch.Tensor  # [..., T] bool — which capacity slots hold real targets


def gate_mask(cfg: RadarConfig) -> np.ndarray:
    """Static per-bin eligibility mask from the distance gate ([K] bool)."""
    k = cfg.range_fft_size
    dist = np.arange(k, dtype=np.float32) * np.float32(cfg.derived.dist_per_bin)
    return (dist >= cfg.algorithm.min_distance) & (dist <= cfg.algorithm.max_distance)


def masked_peaks(profile: torch.Tensor, cfg: RadarConfig) -> torch.Tensor:
    """The profile [..., K] at its eligible bins — local maxima (≥ both
    neighbours, −inf outside the row) inside the distance gate and above
    range_threshold (compared in float32) — and −inf elsewhere."""
    pad = profile.new_full((*profile.shape[:-1], 1), -torch.inf)
    left = torch.cat([pad, profile[..., :-1]], dim=-1)
    right = torch.cat([profile[..., 1:], pad], dim=-1)
    gate = _gate_on(cfg, profile.device)
    eligible = ((profile >= left) & (profile >= right) & gate
                & (profile > cfg.algorithm.range_threshold))
    return torch.where(eligible, profile, -torch.inf)


@functools.lru_cache(maxsize=8)
def _gate_on(cfg: RadarConfig, device: torch.device) -> torch.Tensor:
    """gate_mask on ``device``, copied from the host once per config."""
    return torch.as_tensor(gate_mask(cfg), device=device)


def search_peaks(profile: torch.Tensor, cfg: RadarConfig) -> DetectionResult:
    """Vectorized f_search_peak over arbitrary leading batch dims.

    profile: [..., K] float32 integrated range profile.
    """
    masked = masked_peaks(profile, cfg)
    t = cfg.algorithm.max_num_targets
    if t == 1:
        # argmax returns the first maximal index: the lower bin on ties.
        mag = masked.amax(dim=-1, keepdim=True)
        idx = masked.argmax(dim=-1, keepdim=True)
    else:
        # A STABLE descending sort keeps the lower bin first on ties, as
        # jax.lax.top_k does; torch.topk promises no tie order.
        mag, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
        mag, idx = mag[..., :t], idx[..., :t]
    valid = torch.isfinite(mag)
    return DetectionResult(
        idx=idx.to(torch.int32),
        magnitude=torch.where(valid, mag, 0.0),
        valid=valid,
    )
