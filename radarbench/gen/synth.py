"""Seeded FMCW recordings made on the device.

The signal model of the port's ``io/synth.py`` (one Rx antenna), written
in torch so that a 65,536-frame recording is made on the card in a few
calls instead of seconds of host NumPy. Per frame f, chirp p, sample n:

    x = Σ_t A_t · exp(i·(2π·b_t·n/K + 2π·d_t·p/D)) · present[f]
        + DC + σ·(noise_re + i·noise_im) + calib[n]

with b_t = round(R_t / dist_per_bin) and d_t = (D/2 + offset_t + D/2) mod D
the unshifted Doppler bin, so a target lands in range bin b_t and, after
the fftshift, in Doppler bin D/2 + offset_t. The calibration curve is the
decimated one of ``io/synth.py`` and is added to every chirp.

Muting is exact, not drawn per frame: ``round(muted_share · n)`` frames of
every block of ``n`` frames are muted, at places drawn from the seed, so
every seed gives the same packed lengths (the same work) in another order.

Everything is computed from the configuration's dicts (``device`` and
``algorithm`` as in ``radarbench/configs/*.json``); nothing here imports
the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

C0 = 3.0e8


def dist_per_bin(device: dict, algorithm: dict) -> float:
    """Metres per range bin (radar_processing.m:142-147)."""
    bw = (device["upper_frequency_khz"] - device["lower_frequency_khz"]) * 1e3
    r_max = device["num_samples_per_chirp"] * C0 / (2.0 * bw)
    return r_max / algorithm["range_fft_size"]


def calib_vector(nts: int) -> np.ndarray:
    """The calibration curve as a complex [NTS] vector: I and Q of
    ``io/synth.py`` sampled at 2·NTS points, decimated by 2."""
    n_cal = 2 * nts
    m = np.arange(n_cal)
    cal_i = 0.3 + 0.05 * np.cos(2 * np.pi * m / n_cal)
    cal_q = 0.15 + 0.03 * np.sin(2 * np.pi * m / n_cal)
    return (cal_i[::2] + 1j * cal_q[::2]).astype(np.complex64)


def muted_mask(frames: int, block: int, share: float,
               gen: torch.Generator, device) -> torch.Tensor:
    """[frames] bool, True where targets are present: in every block of
    ``block`` frames exactly round(share · block) are muted, at places
    drawn from ``gen``."""
    if frames % block:
        raise ValueError(f"{frames} frames are not whole blocks of {block}")
    n_mute = int(round(share * block))
    blocks = frames // block
    keys = torch.rand((blocks, block), generator=gen, device=device)
    order = keys.argsort(dim=1)
    present = torch.ones((blocks, block), dtype=torch.bool, device=device)
    present.scatter_(1, order[:, :n_mute], False)
    return present.reshape(frames)


def recording(device_cfg: dict, algorithm: dict, frames: int, targets: list,
              *, gen: torch.Generator, device, muted_share: float = 0.1,
              mute_block: int | None = None, noise_sigma: float = 0.01,
              dc_offset=(0.2, 0.1)):
    """One recording on ``device``: (raw [F, PN, 2·NTS] float32 flat pair
    rows, calib [NTS, 2] float32, present [F] bool), all torch tensors on
    ``device``. ``targets``: dicts with range_m, doppler_bin_offset and
    amplitude. ``mute_block``: the block of exact muting (default: F)."""
    nts = device_cfg["num_samples_per_chirp"]
    pn = device_cfg["num_chirps_per_frame"]
    k = algorithm["range_fft_size"]
    d = algorithm["doppler_fft_size"]
    dpb = dist_per_bin(device_cfg, algorithm)
    present = muted_mask(frames, mute_block or frames, muted_share, gen, device)
    n = torch.arange(nts, dtype=torch.float64, device=device)
    p = torch.arange(pn, dtype=torch.float64, device=device)
    chirp = torch.zeros((pn, nts), dtype=torch.complex128, device=device)
    for t in targets:
        b = int(round(t["range_m"] / dpb))
        d_unshifted = (d // 2 + int(t["doppler_bin_offset"]) + d // 2) % d
        phase = (2 * math.pi * b * n / k)[None, :] + (2 * math.pi * d_unshifted * p / d)[:, None]
        chirp = chirp + float(t.get("amplitude", 4.0)) * torch.exp(1j * phase)
    calib = torch.as_tensor(calib_vector(nts), device=device)
    base = (chirp.to(torch.complex64), complex(*dc_offset) + calib)  # [PN, NTS], [NTS]
    noise = torch.randn((frames, pn, nts, 2), generator=gen, device=device)
    raw = noise.mul_(noise_sigma)
    raw[..., 0] += base[1].real
    raw[..., 1] += base[1].imag
    sig = torch.view_as_real(base[0])  # [PN, NTS, 2]
    raw += present.to(torch.float32)[:, None, None, None] * sig
    calib_pair = torch.view_as_real(calib).contiguous()
    return raw.reshape(frames, pn, 2 * nts), calib_pair, present


def generator(seed: int, device) -> torch.Generator:
    """A torch generator on ``device`` seeded with ``seed`` (any whole
    number below 2**63; negative seeds fold into it)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    return g
