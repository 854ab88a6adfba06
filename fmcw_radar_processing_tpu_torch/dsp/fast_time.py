"""Fast-time (range) processing as one packed real matmul.

The reference's fast-time chain (radar_processing.m:201-207) is, per chirp
column x ∈ C^NTS: calibration subtract and IF scale, per-chirp DC removal,
the 2·blackman range window, and a zero-padded K-point FFT. Every step is
linear or affine in x, so the chain collapses to

    Y = M x − M·calib,   M = F_K[:, :NTS] · diag(2·blackman) · (I − 11ᵀ/NTS) · IF_scale

one K×NTS complex matrix built on the host in float64
(:func:`build_fast_time_matrix`). :class:`PackedFastTime` applies it as ONE
real [2·NTS, 2·K] matmul over flat pair rows, with INTERLEAVED output
columns (column 2k is the real part of bin k, 2k+1 its imaginary part).
The CUDA profile kernel (ops/fast_time_cuda.py) takes a different packing,
with BLOCKED re|im columns.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fmcw_radar_processing_tpu.config import RadarConfig
from fmcw_radar_processing_tpu_torch.dsp.windows import blackman
from fmcw_radar_processing_tpu_torch.utils.cplx import pair_abs, pin_f32_matmul


def dft_matrix(k: int, n: int) -> np.ndarray:
    """First ``n`` columns of the K-point DFT matrix (zero-padding operator)."""
    kk = np.arange(k)[:, None]
    nn = np.arange(n)[None, :]
    return np.exp(-2j * np.pi * kk * nn / k)


def build_fast_time_matrix(cfg: RadarConfig) -> np.ndarray:
    """M = F_K[:, :NTS] · diag(2·blackman) · (I − 11ᵀ/NTS) · IF_scale."""
    nts = cfg.nts
    k = cfg.range_fft_size
    w = 2.0 * blackman(nts)
    demean = np.eye(nts) - np.full((nts, nts), 1.0 / nts)
    m = dft_matrix(k, nts) @ np.diag(w) @ demean * cfg.derived.if_scale
    return m.astype(np.complex128)


@dataclasses.dataclass(frozen=True)
class PackedFastTime:
    """The fast-time operator as one real matmul on flat pair rows.

        X [rows, 2n+(0|1)] = (re|im) of sample n
        W [2n+0, 2k+0] =  M.re[k,n]    W [2n+0, 2k+1] = M.im[k,n]
        W [2n+1, 2k+0] = −M.im[k,n]    W [2n+1, 2k+1] = M.re[k,n]
        Y = X @ W  →  Y [rows, 2k+(0|1)] = (re|im) of bin k

    ``w`` is the host copy; ``w_t`` the same matrix on ``device``.
    """

    w: np.ndarray  # (2·NTS, 2·K) float32, interleaved output columns
    w_t: torch.Tensor
    nts: int
    k: int

    @classmethod
    def create(cls, cfg: RadarConfig,
               device: torch.device | str = "cpu") -> "PackedFastTime":
        m = build_fast_time_matrix(cfg)  # (K, NTS) complex
        k, nts = m.shape
        w = np.zeros((2 * nts, 2 * k), np.float32)
        w[0::2, 0::2] = m.real.T
        w[0::2, 1::2] = m.imag.T
        w[1::2, 0::2] = -m.imag.T
        w[1::2, 1::2] = m.real.T
        return cls(w=w, w_t=torch.as_tensor(w, device=device), nts=nts, k=k)

    def _flat_rows(self, raw: torch.Tensor) -> torch.Tensor:
        """[..., NTS, 2] pair or [..., 2·NTS] flat rows → [..., 2·NTS] f32."""
        raw = raw.to(torch.float32)
        if raw.shape[-1] == 2 * self.nts:
            return raw
        return raw.reshape(*raw.shape[:-2], 2 * self.nts)

    def offset(self, calib: torch.Tensor) -> torch.Tensor:
        """M @ calib as a pair [K, 2] (the affine calibration part), exact f32."""
        pin_f32_matmul()
        flat = calib.to(torch.float32).reshape(1, 2 * self.nts)
        return (flat @ self.w_t).reshape(self.k, 2)

    def rf(self, raw: torch.Tensor, calib: torch.Tensor) -> torch.Tensor:
        """Full range FFT [..., PN, K, 2] via one matmul."""
        pin_f32_matmul()
        x = self._flat_rows(raw)
        y = (x @ self.w_t).reshape(*x.shape[:-1], self.k, 2)
        return y - self.offset(calib)

    def profile(self, raw: torch.Tensor, calib: torch.Tensor) -> torch.Tensor:
        """Integrated range profile [..., K]: max over chirps of |range FFT|
        (radar_processing.m:205,210) — what kernel K1 computes."""
        y = self.rf(raw, calib)
        return torch.sqrt(y[..., 0] ** 2 + y[..., 1] ** 2).amax(dim=-2)

    def rf_at_bins(self, raw: torch.Tensor, calib: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
        """Range-FFT chirp rows at selected bins only: [F, PN, T, 2].

        raw: [F, PN, 2·NTS] (or pair layout); idx: [F, T] range-bin
        indices. Gathers the 2·T weight columns per frame and recomputes —
        never touches a [F, PN, K, 2] tensor.
        """
        pin_f32_matmul()
        f, t = idx.shape
        x = self._flat_rows(raw).reshape(f, -1, 2 * self.nts)  # [F, PN, 2NTS]
        cols = (idx.to(torch.int64)[..., None] * 2
                + torch.arange(2, device=idx.device)).reshape(f, 2 * t)
        w_sel = self.w_t.T[cols]  # [F, 2T, 2NTS]
        y = torch.bmm(x, w_sel.transpose(1, 2))  # [F, PN, 2T]
        y = y.reshape(f, x.shape[1], t, 2)
        off = self.offset(calib)[idx.to(torch.int64)]  # [F, T, 2]
        return y - off[:, None]


def range_profile(range_fft: torch.Tensor) -> torch.Tensor:
    """Non-coherent integration across chirps (radar_processing.m:210): the
    max over chirps of |range FFT|, which is MATLAB's abs(max(X, [], 2)).

    range_fft: [..., PN, K, 2] → profile [..., K] float32.
    """
    return pair_abs(range_fft).amax(dim=-2)
