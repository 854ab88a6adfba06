"""STFT / micro-Doppler spectrogram: host operators and plain PyTorch ops.

The reference computes (radar_processing.m:270-299): the one-sided PSD
spectrogram of |slow-time signal| with kaiser(20, 3), hop 1 and
nfft = 2^nextpow2(L); dB as 20·log10(P / max P); and a linear re-gridding
onto 1024 log-spaced frequency bins. Each STFT column is the zero-padded
FFT of a 20-sample windowed segment, S[:, t] = A·x[t : t+20] with
A = F_nfft[:nb, :20] · diag(kaiser). The export kernels (ops/stft_cuda.py)
compute that product, the dB map and the re-gridding; this module holds
the host-built operators and the plain tensor functions their plain
versions are made of. Semantics follow the JAX package's ``dsp/stft.py``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from fmcw_radar_processing_tpu_torch.dsp.windows import kaiser
from fmcw_radar_processing_tpu_torch.utils.cplx import pin_f32_matmul

DB_FLOOR = -1000.0
"""dB floor standing in for MATLAB's −inf at P = 0 (radar_processing.m:283);
exactly representable in bfloat16, so floor equality survives a bf16 store."""

INT8_DB_RANGE = (-41.0, 1.0)
"""Affine-quantization range of the int8 intensity emission (dB), around
the reference PNG's clim [−40, 0] (radar_processing.m:340)."""

LN10_INV_20 = float(20.0 / np.log(10.0))


def int8_db_step() -> float:
    lo, hi = INT8_DB_RANGE
    return (hi - lo) / 255.0


INT8_SCALE = float(np.float32(1.0 / int8_db_step()))
"""Codes per dB of the int8 emission, as the float32 the kernels use."""


class SpectrogramResult(NamedTuple):
    power: torch.Tensor  # [..., nb, T] float32 linear PSD, invalid columns zeroed
    frame_valid: torch.Tensor  # [..., T] bool — columns within the valid signal
    freqs: torch.Tensor  # [nb] float32 one-sided frequency axis (Hz)
    times: torch.Tensor  # [T] float32 segment-center times (s)


def stft_frame_count(length: int, window_length: int, hop: int) -> int:
    """Number of STFT columns for a length-L signal (MATLAB fix((L−o)/(w−o)))."""
    if length < window_length:
        return 0
    return (length - window_length) // hop + 1


@dataclasses.dataclass(frozen=True)
class StftOperator:
    """Framed-matmul STFT for fixed (window, nfft, fs, hop)."""

    a_re: np.ndarray  # (nb, W) float32 host constant
    a_im: np.ndarray  # (nb, W) float32
    window_length: int
    nfft: int
    hop: int
    fs: float
    scale: float  # 1 / (fs · Σw²)
    # Per-device copies of the stacked operator and the doubling vector,
    # made once so that a call copies nothing from the host.
    _on_device: dict = dataclasses.field(default_factory=dict, init=False,
                                         repr=False, compare=False, hash=False)

    @classmethod
    def create(cls, *, window_length: int = 20, beta: float = 3.0, nfft: int,
               fs: float, hop: int = 1) -> "StftOperator":
        w = kaiser(window_length, beta)
        nb = nfft // 2 + 1
        kk = np.arange(nb)[:, None]
        nn = np.arange(window_length)[None, :]
        a = np.exp(-2j * np.pi * kk * nn / nfft) * w[None, :]
        return cls(
            a_re=a.real.astype(np.float32),
            a_im=a.imag.astype(np.float32),
            window_length=window_length,
            nfft=nfft,
            hop=hop,
            fs=float(fs),
            scale=float(1.0 / (fs * np.sum(w**2))),
        )

    @property
    def num_bins(self) -> int:
        return self.nfft // 2 + 1

    def frame_signal(self, x: torch.Tensor) -> torch.Tensor:
        """Sliding-window frame matrix: [..., L] → [..., W, T] (a strided
        view, no copy)."""
        return x.unfold(-1, self.window_length, self.hop).transpose(-1, -2)

    def _device_operator(self, device: torch.device):
        """(A2 = [a_re; a_im] [2·nb, W], one-sided doubling [nb, 1]) on
        ``device``."""
        if device not in self._on_device:
            dbl = np.full((self.num_bins, 1), 2.0, np.float32)
            dbl[0] = 1.0
            if self.nfft % 2 == 0:
                dbl[-1] = 1.0
            a2 = np.concatenate([self.a_re, self.a_im], axis=0)
            self._on_device[device] = (torch.as_tensor(a2, device=device),
                                       torch.as_tensor(dbl, device=device))
        return self._on_device[device]

    def __call__(self, x: torch.Tensor,
                 valid_len: torch.Tensor | int | None = None) -> SpectrogramResult:
        """One-sided PSD spectrogram of a real signal (the JAX package's
        ``StftOperator.__call__``), by one stacked float32 product.

        x: [..., L] float32 (|·| of the slow-time signal), L ≥ W.
        valid_len: optional count of valid samples, scalar or one per
          leading index; columns reaching past it are zeroed.
        """
        pin_f32_matmul()
        a2, dbl = self._device_operator(x.device)
        frames = self.frame_signal(x.to(torch.float32))  # [..., W, T]
        s2 = torch.matmul(a2, frames)  # [..., 2·nb, T]
        nb = self.num_bins
        s_re, s_im = s2[..., :nb, :], s2[..., nb:, :]
        p = (s_re * s_re + s_im * s_im) * float(np.float32(self.scale))
        p = p * dbl
        t = p.shape[-1]
        cols = torch.arange(t, device=x.device)
        if valid_len is None:
            frame_valid = torch.ones(x.shape[:-1] + (t,), dtype=torch.bool,
                                     device=x.device)
        else:
            valid_len = torch.as_tensor(valid_len, device=x.device)
            n_valid = torch.div(valid_len - self.window_length, self.hop,
                                rounding_mode="floor") + 1
            frame_valid = cols < n_valid[..., None]
            p = torch.where(frame_valid[..., None, :], p, 0.0)
        freqs = (torch.arange(nb, dtype=torch.float32, device=x.device)
                 * float(np.float32(self.fs / self.nfft)))
        times = ((cols.to(torch.float32) * self.hop + self.window_length / 2.0)
                 / float(np.float32(self.fs)))
        return SpectrogramResult(power=p, frame_valid=frame_valid, freqs=freqs,
                                 times=times)


def quantize_db_int8(db: torch.Tensor) -> torch.Tensor:
    """dB float32 → int8 code: round((db − lo)/step) − 128, half to even."""
    lo, _ = INT8_DB_RANGE
    q = torch.clamp(torch.round((db - lo) * INT8_SCALE), 0.0, 255.0)
    return (q - 128.0).to(torch.int8)


def decode_db_int8(arr) -> np.ndarray:
    """Host-side inverse of :func:`quantize_db_int8` (int8 codes → dB f32)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    lo, _ = INT8_DB_RANGE
    return ((np.asarray(arr, np.float32) + 128.0)
            * np.float32(int8_db_step()) + np.float32(lo))


def psd_db(power: torch.Tensor, gmax: torch.Tensor | None = None) -> torch.Tensor:
    """Reference dB normalization 20·log10(P / gmax) (radar_processing.m:
    282-283), written as the export kernel computes it:
    ``LN10_INV_20 · ln(max(P, 1e-45) / gmax)``, floored at DB_FLOOR, with
    P = 0 → DB_FLOOR and the G > 0 guard. ``gmax`` defaults to the global
    max of ``power``; a tensor of one max per leading index broadcasts.
    The constants are Python scalars, so nothing is copied from the host."""
    if gmax is None:
        gmax = power.amax()
    safe = torch.where(gmax > 0, gmax, torch.ones_like(gmax))
    db = LN10_INV_20 * torch.log(torch.clamp_min(power, 1e-45) / safe)
    return torch.where(power > 0, torch.clamp_min(db, DB_FLOOR), DB_FLOOR)


@functools.lru_cache(maxsize=32)
def _log_interp_matrix(nb: int, num_bins: int) -> np.ndarray:
    """Static interpolation operator W [num_bins, nb]: linear interpolation
    onto logspace(0, log10(nb−1)) in units of the bin width — two nonzeros
    per row, at i0 and i0+1."""
    pos = np.logspace(0.0, np.log10(nb - 1), num_bins)
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, nb - 2)
    frac = pos - i0
    w = np.zeros((num_bins, nb), np.float32)
    rows = np.arange(num_bins)
    w[rows, i0] = (1.0 - frac).astype(np.float32)
    w[rows, i0 + 1] += frac.astype(np.float32)
    return w


def log_bins_axis(freqs: np.ndarray, num_bins: int = 1024) -> np.ndarray:
    """The log-spaced output frequency axis of the rescale (Hz),
    logspace(log10(freqs[1]), log10(freqs[-1]), num_bins), float32."""
    nb = freqs.shape[0]
    return np.float32(freqs[1]) * (
        np.logspace(0.0, np.log10(nb - 1), num_bins, dtype=np.float64)
        .astype(np.float32))


def log_interp(values: torch.Tensor, num_bins: int = 1024) -> torch.Tensor:
    """Interpolate [..., nb, T] onto the log grid: the dense float32
    contraction over the first nb−1 bins plus the Nyquist column as a
    rank-1 term → [..., num_bins, T]."""
    pin_f32_matmul()
    nb = values.shape[-2]
    w = torch.as_tensor(_log_interp_matrix(nb, num_bins), device=values.device)
    return (torch.matmul(w[:, : nb - 1], values[..., : nb - 1, :])
            + w[:, nb - 1 : nb] * values[..., nb - 1 : nb, :])


def log_frequency_rescale(
    freqs: np.ndarray, values: torch.Tensor, num_bins: int = 1024,
    method: str = "matmul",
) -> tuple[np.ndarray, torch.Tensor]:
    """Log-spaced frequency re-gridding (radar_processing.m:291-299).

    freqs: [nb] uniform host axis; values: [..., nb, T].
    method: "matmul" (:func:`log_interp`) or "gather" (two row gathers and
    ``lo + frac·(hi − lo)``), the JAX package's two formulations, both
    exact float32 here.
    Returns (log_bins [num_bins], interp [..., num_bins, T]).
    """
    if method == "gather":
        nb = values.shape[-2]
        pos = np.logspace(0.0, np.log10(nb - 1), num_bins)
        i0 = np.clip(np.floor(pos).astype(np.int64), 0, nb - 2)
        frac = torch.as_tensor((pos - i0).astype(np.float32),
                               device=values.device)[:, None]
        i0 = torch.as_tensor(i0, device=values.device)
        lo, hi = values[..., i0, :], values[..., i0 + 1, :]
        return log_bins_axis(freqs, num_bins), lo + frac * (hi - lo)
    if method != "matmul":
        raise ValueError(f"unknown rescale method {method!r}")
    return log_bins_axis(freqs, num_bins), log_interp(values, num_bins)
