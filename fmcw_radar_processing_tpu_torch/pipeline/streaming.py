"""Streaming multi-sensor pipeline: C radar channels, windowed frames.

The JAX package's ``pipeline/streaming.py`` on PyTorch. Each call of
:meth:`StreamingProcessor.process_window` takes one window of frames from
C channels:

  * the per-frame chain (pipeline/frame_chain.py, kernel K1 on a CUDA
    device) runs once per channel, each with its own calibration offset,
    so a window launches K1 C times;
  * the slow-time/STFT state is streaming: each channel carries the last
    W−1 packed slow-time samples across window boundaries, so spectrogram
    columns are seamless across windows;
  * dB normalization is ``per_window`` (each window by its own max) or
    ``running_max`` (by the max seen so far on the channel); the offline
    :func:`normalize_two_pass` recovers the reference's whole-recording
    max (radar_processing.m:282-283) from collected windows.

The state (carry [C, W−1], carry_len [C], max_power [C]) lives on the
processor's device between windows. The left alignment of each channel's
stream and the next carry are index gathers on the device, so a window
whose inputs already lie on the device costs no host synchronization.

Not ported: the JAX ``mesh`` argument, which shards the channels over a
device mesh (ROADMAP.md, Queue 1 item 11).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fmcw_radar_processing_tpu.config import RadarConfig
from fmcw_radar_processing_tpu_torch.dsp.stft import DB_FLOOR, StftOperator, psd_db
from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import (
    make_frame_chain,
    pack_slow_time,
)
from fmcw_radar_processing_tpu_torch.utils.cplx import pair_abs

DB_MODES = ("per_window", "running_max")


class StreamingWindowResult(NamedTuple):
    """Per-window outputs, leading axis = channel, on the processor's device."""

    waterfall: torch.Tensor  # [C, F, K]
    range: torch.Tensor  # [C, T, F] NaN-filled
    speed: torch.Tensor  # [C, T, F]
    strength: torch.Tensor  # [C, T, F]
    detected: torch.Tensor  # [C, F]
    psd: torch.Tensor  # [C, nb, Lcap] linear PSD, zero past col_count
    psd_db: torch.Tensor  # [C, nb, Lcap] dB per db_mode (floor past col_count)
    norm_power: torch.Tensor  # [C] the power each channel was normalized by
    col_count: torch.Tensor  # [C] valid STFT columns this window
    carry: torch.Tensor  # [C, W-1] next window's carry (opaque state)


class StreamingProcessor:
    """Stateful multi-channel streaming processor on one device.

    window_frames: frames per processing window per channel.
    db_mode: "per_window" or "running_max" (see the module docstring).
    """

    def __init__(self, cfg: RadarConfig, channels: int, window_frames: int,
                 device: torch.device | str, nfft: int = 256,
                 db_mode: str = "per_window"):
        if db_mode not in DB_MODES:
            raise ValueError(f"unknown db_mode {db_mode!r}")
        self.cfg = cfg
        self.channels = channels
        self.window_frames = window_frames
        self.device = torch.device(device)
        self.nfft = nfft
        self.db_mode = db_mode
        a = cfg.algorithm
        self._wl = a.stft_window_length
        self._chain = make_frame_chain(cfg, self.device)
        self._stft = StftOperator.create(
            window_length=self._wl, beta=a.stft_kaiser_beta, nfft=nfft,
            fs=1.0 / cfg.derived.prt, hop=1)
        self.reset()

    def reset(self) -> None:
        c, dev = self.channels, self.device
        self._carry = torch.zeros((c, self._wl - 1), dtype=torch.float32,
                                  device=dev)
        self._carry_len = torch.zeros((c,), dtype=torch.int32, device=dev)
        self._max_power = torch.zeros((c,), dtype=torch.float32, device=dev)

    def process_window(self, raw, calib) -> StreamingWindowResult:
        """Process one window.

        raw: [C, F, PN, 2·NTS] flat pair rows or [C, F, PN, NTS, 2];
        calib: [C, NTS, 2]. NumPy arrays or tensors (on any device).
        """
        dev, wl = self.device, self._wl
        raw = torch.as_tensor(raw, dtype=torch.float32, device=dev)
        calib = torch.as_tensor(calib, dtype=torch.float32, device=dev)
        if raw.ndim == 5:
            raw = raw.reshape(*raw.shape[:3], -1)
        if raw.shape[0] != self.channels or calib.shape[0] != self.channels:
            raise ValueError(f"expected {self.channels} channels, got raw "
                             f"{tuple(raw.shape)}, calib {tuple(calib.shape)}")
        raw = raw.contiguous()
        outs, mags, counts = [], [], []
        for c in range(self.channels):
            out = self._chain(raw[c], calib[c])
            sig, count = pack_slow_time(out.strongest_chirps, out.detected,
                                        self.cfg.pn)
            outs.append(out)
            mags.append(pair_abs(sig))  # [F·PN], valid in [0, count)
            counts.append(count)
        mag = torch.stack(mags)  # [C, F·PN]
        count = torch.stack(counts)  # [C]
        carry_len = self._carry_len
        # Invariant: carry holds the previous window's last carry_len stream
        # samples RIGHT-aligned in a [W−1] zero-padded buffer, so ext's valid
        # stream is contiguous at [W−1−carry_len, W−1+count).
        ext = torch.cat([self._carry, mag], dim=1)  # [C, W−1 + F·PN]
        n = ext.shape[1]
        total = carry_len + count
        # Left-align the stream at 0 (jnp.roll by carry_len − (W−1)): the
        # operator's valid_len masking is prefix-based. The wrapped tail is
        # zeros and masked anyway.
        pos = torch.arange(n, device=dev)
        src = torch.remainder(pos[None, :] + (wl - 1) - carry_len[:, None], n)
        aligned = torch.gather(ext, 1, src)
        res = self._stft(aligned, valid_len=total)
        n_cols = torch.clamp_min(total - wl + 1, 0)
        # Valid columns carry power > 0 and invalid ones are zeroed, so the
        # window max is the valid max.
        wmax = res.power.amax(dim=(-2, -1))
        new_max = torch.maximum(self._max_power, wmax)
        norm = new_max if self.db_mode == "running_max" else wmax
        db = psd_db(res.power, norm[:, None, None])
        # Next carry: the last min(total, W−1) stream samples, right-aligned
        # (W−1 zeros in front keep the zero pad of a short stream).
        y = torch.cat([torch.zeros_like(self._carry), aligned], dim=1)
        idx = total[:, None].to(torch.int64) + torch.arange(wl - 1, device=dev)
        self._carry = torch.gather(y, 1, idx)
        self._carry_len = torch.clamp_max(total, wl - 1)
        self._max_power = new_max
        return StreamingWindowResult(
            waterfall=torch.stack([o.waterfall for o in outs]),
            range=torch.stack([o.range for o in outs]),
            speed=torch.stack([o.speed for o in outs]),
            strength=torch.stack([o.strength for o in outs]),
            detected=torch.stack([o.detected for o in outs]),
            psd=res.power, psd_db=db, norm_power=norm, col_count=n_cols,
            carry=self._carry,
        )


def normalize_two_pass(
    window_psds: list[np.ndarray], col_counts: list[np.ndarray]
) -> list[np.ndarray]:
    """Offline two-pass dB normalization over collected streaming windows.

    The reference's global-max semantics (radar_processing.m:282-283 with
    the :547-552 G>0 guard): pass 1 finds the global max power over every
    valid column of every window (per channel), pass 2 renders each
    window's dB against it. Feed it the ``psd``/``col_count`` fields of the
    StreamingWindowResults (as NumPy arrays); returns per-window
    [C, nb, Lcap] float32 dB arrays.

    Columns at index >= col_count are masked out of the max and floored in
    the output, whether or not the producer zeroed them.
    """

    def valid_mask(p: np.ndarray, cc) -> np.ndarray:
        cols = np.arange(p.shape[-1])
        return cols[None, None, :] < np.asarray(cc)[:, None, None]

    gmax = None
    for p, cc in zip(window_psds, col_counts):
        p = np.asarray(p)
        w = np.max(np.where(valid_mask(p, cc), p, 0.0), axis=(-2, -1))  # [C]
        gmax = w if gmax is None else np.maximum(gmax, w)
    safe = np.where(gmax > 0, gmax, 1.0).astype(np.float64)[:, None, None]
    out = []
    for p, cc in zip(window_psds, col_counts):
        # float64: 1e-45 underflows to 0 in float32 and trips log10(0).
        p = np.asarray(p, np.float64)
        db = np.where(
            (p > 0) & valid_mask(p, cc),
            np.maximum(20.0 * np.log10(np.maximum(p, 1e-300) / safe), DB_FLOOR),
            DB_FLOOR,
        )
        out.append(db.astype(np.float32))
    return out
