"""The plain reference of the per-frame chain and of the slow-time packing,
in float64 PyTorch (radar_processing.m:197-265).

Per frame: calibration subtract, per-chirp DC removal, the 2·blackman
window and a zero-padded K-point FFT scaled by IF_scale; the profile is
the max over chirps of |range FFT|; the strongest local maximum inside the
distance gate and above the range threshold is the target; at its bin the
chirp rows go through mean removal, 2·chebwin(PN) and a D-point FFT,
fftshifted, whose peak gives the speed unless it is below the Doppler
threshold or on the zero bin. The detected frames' chirp rows at that bin,
concatenated in frame order, are the slow-time signal of the spectrogram.

Derived radar values come from the configuration's dicts, as
radar_processing.m:131-154 computes them. This module imports nothing of
the program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from radarbench.reference.windows import blackman, chebwin

C0 = 3.0e8


class Derived(NamedTuple):
    prt: float
    dist_per_bin: float
    speed_step: float  # m/s per Doppler bin offset
    if_scale: float


def derived(device: dict, algorithm: dict) -> Derived:
    up = device["chirp_duration_ns"] * 1e-9
    prt = up + algorithm["down_chirp_duration"] + algorithm["chirp_to_chirp_delay"]
    bw = (device["upper_frequency_khz"] - device["lower_frequency_khz"]) * 1e3
    fc = (device["upper_frequency_khz"] + device["lower_frequency_khz"]) / 2.0 * 1e3
    nts, k = device["num_samples_per_chirp"], algorithm["range_fft_size"]
    fd_per_bin = 1.0 / (2.0 * prt) / algorithm["doppler_fft_size"]
    return Derived(prt=prt, dist_per_bin=nts * C0 / (2.0 * bw) / k,
                   speed_step=-fd_per_bin * (C0 / fc) / 2.0,
                   if_scale=16.0 * 3.3 * k / nts)


class ChainRef(NamedTuple):
    """Reference per-frame outputs of F frames (float64 / int64, on the
    device the inputs came on)."""

    profile: torch.Tensor  # [F, K] max over chirps of |range FFT|
    detected: torch.Tensor  # [F] bool
    range_bin: torch.Tensor  # [F] int64, −1 where not detected
    doppler_offset: torch.Tensor  # [F] int64 fftshifted bin − D/2, 0 where rejected
    strength: torch.Tensor  # [F] profile at the peak, NaN where not detected
    rows: torch.Tensor  # [F, PN] complex128 chirp rows at the peak bin


def range_fft(raw: torch.Tensor, calib: torch.Tensor, device: dict,
              algorithm: dict) -> torch.Tensor:
    """[F, PN, K] complex128 range FFT of raw [F, PN, 2·NTS] float pairs and
    calib [NTS, 2]."""
    nts = device["num_samples_per_chirp"]
    x = raw.to(torch.float64).reshape(*raw.shape[:2], nts, 2)
    c = calib.to(torch.float64)
    y = torch.complex(x[..., 0] - c[:, 0], x[..., 1] - c[:, 1])
    y = y - y.mean(dim=-1, keepdim=True)
    y = y * torch.as_tensor(2.0 * blackman(nts), device=y.device)
    d = derived(device, algorithm)
    return torch.fft.fft(y, n=algorithm["range_fft_size"], dim=-1) * d.if_scale


def chain(raw: torch.Tensor, calib: torch.Tensor, device: dict,
          algorithm: dict) -> ChainRef:
    """The reference chain over a block of frames (max_num_targets 1)."""
    if algorithm["max_num_targets"] != 1:
        raise ValueError("the reference chain takes max_num_targets 1")
    d = derived(device, algorithm)
    rf = range_fft(raw, calib, device, algorithm)  # [F, PN, K]
    profile = rf.abs().amax(dim=1)  # [F, K]
    k = profile.shape[-1]
    dist = torch.arange(k, dtype=torch.float64, device=rf.device) * d.dist_per_bin
    gate = (dist >= algorithm["min_distance"]) & (dist <= algorithm["max_distance"])
    pad = torch.full_like(profile[:, :1], -torch.inf)
    left = torch.cat([pad, profile[:, :-1]], dim=1)
    right = torch.cat([profile[:, 1:], pad], dim=1)
    ok = ((profile >= left) & (profile >= right) & gate
          & (profile > algorithm["range_threshold"]))
    masked = torch.where(ok, profile, -torch.inf)
    peak = masked.argmax(dim=1)  # the lower bin on ties
    detected = torch.isfinite(masked.amax(dim=1))
    rows = torch.gather(rf, 2, peak[:, None, None].expand(-1, rf.shape[1], 1))[..., 0]
    pn, dd = rows.shape[1], algorithm["doppler_fft_size"]
    r = rows - rows.mean(dim=1, keepdim=True)
    r = r * torch.as_tensor(2.0 * chebwin(pn), device=r.device)
    spec = torch.fft.fftshift(torch.fft.fft(r, n=dd, dim=1), dim=1).abs()
    dop = spec.argmax(dim=1)
    zero = dd // 2
    accept = (spec.amax(dim=1) >= algorithm["doppler_threshold"]) & (dop != zero)
    dop = torch.where(accept, dop, zero)
    strength = torch.where(detected, profile.gather(1, peak[:, None])[:, 0], torch.nan)
    return ChainRef(profile=profile, detected=detected,
                    range_bin=torch.where(detected, peak, -1),
                    doppler_offset=dop - zero, strength=strength, rows=rows)


def packed_magnitude(rows: torch.Tensor, detected: torch.Tensor) -> torch.Tensor:
    """|slow-time signal|: the detected frames' chirp rows in frame order,
    flattened (radar_processing.m:255-260, :270) → [count] float64."""
    return rows[detected].reshape(-1).abs()


def blocks(frames: int, size: int):
    """Frame slices of at most ``size`` frames covering ``frames``."""
    for s in range(0, frames, size):
        yield slice(s, min(s + size, frames))


def chain_blocked(raw: np.ndarray, calib: np.ndarray, device_cfg: dict,
                  algorithm: dict, on, block: int = 8192):
    """The reference chain over a host recording, ``block`` frames at a time
    on the torch device ``on``; returns the per-frame outputs on ``on``,
    concatenated (``rows`` only where detected, as the packed magnitude)."""
    cal = torch.as_tensor(calib, device=on)
    parts = []
    for sl in blocks(raw.shape[0], block):
        r = chain(torch.as_tensor(raw[sl], device=on), cal, device_cfg, algorithm)
        parts.append(r._replace(rows=packed_magnitude(r.rows, r.detected)))
    return ChainRef(*(torch.cat([getattr(p, f) for p in parts])
                      for f in ChainRef._fields))
