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
:class:`FastTimeOperator` applies it as four real einsums over the
re/im planes (the JAX package's impl "xla"). The CUDA profile kernels
(ops/fast_time_cuda.py) take a different packing, with BLOCKED re|im
columns.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from fmcw_radar_processing_tpu_torch.config import RadarConfig
from fmcw_radar_processing_tpu_torch.dsp.windows import blackman
from fmcw_radar_processing_tpu_torch.utils.cplx import (
    mxu_passes,
    mxu_terms,
    pair_abs,
    pair_matmul,
    pin_f32_matmul,
    precision_matmul,
)


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
class FastTimeOperator:
    """The fast-time operator as a complex contraction of the re/im planes:
    four real float32 einsums (utils/cplx.py::pair_matmul), the JAX
    package's ``FastTimeOperator`` (impl "xla")."""

    m_re: torch.Tensor  # (K, NTS) float32 on the operator's device
    m_im: torch.Tensor

    @classmethod
    def create(cls, cfg: RadarConfig,
               device: torch.device | str) -> "FastTimeOperator":
        m = build_fast_time_matrix(cfg)
        return cls(m_re=torch.as_tensor(m.real.astype(np.float32), device=device),
                   m_im=torch.as_tensor(m.imag.astype(np.float32), device=device))

    def offset(self, calib: torch.Tensor) -> torch.Tensor:
        """M @ calib (the affine part). calib: [NTS, 2] pair → [K, 2]."""
        return pair_matmul(calib.to(torch.float32), self.m_re, self.m_im,
                           "n,kn->k")

    def __call__(self, raw: torch.Tensor, calib: torch.Tensor) -> torch.Tensor:
        """Range FFT [..., PN, K, 2] of raw [..., PN, NTS, 2] pairs or flat
        pair rows [..., PN, 2·NTS], minus the calibration offset."""
        nts = self.m_re.shape[1]
        if raw.shape[-1] == 2 * nts:
            raw = raw.reshape(*raw.shape[:-1], nts, 2)
        y = pair_matmul(raw.to(torch.float32), self.m_re, self.m_im,
                        "...pn,kn->...pk")
        return y - self.offset(calib)


@dataclasses.dataclass(frozen=True)
class PackedFastTime:
    """The fast-time operator as one real matmul on flat pair rows.

        X [rows, 2n+(0|1)] = (re|im) of sample n
        W [2n+0, 2k+0] =  M.re[k,n]    W [2n+0, 2k+1] = M.im[k,n]
        W [2n+1, 2k+0] = −M.im[k,n]    W [2n+1, 2k+1] = M.re[k,n]
        Y = X @ W  →  Y [rows, 2k+(0|1)] = (re|im) of bin k

    ``w`` is the host copy; ``w_t`` the same matrix on ``device``.

    ``compute_dtype`` is the operand type of :meth:`rf` and :meth:`profile`
    (the JAX package's impls "fused", float32, and "fused_bf16",
    bfloat16). At bfloat16 both operands are rounded to bf16 and multiplied
    in float32: every product of two bf16 values is exact there, so this is
    the TPU's bf16 pass with float32 accumulation, with a float32 result
    (a bf16 ``torch.matmul`` would round every output to bf16 as well).

    ``precision`` is the TPU's pass count of the float32 products of
    :meth:`rf`, :meth:`profile` and :meth:`rf_at_bins`
    (``AlgorithmConfig.matmul_precision``; utils/cplx.py::precision_matmul:
    the passes on the card, exact float32 on the CPU). The bf16
    ``compute_dtype`` ignores it, and :meth:`offset` is exact float32 at
    every precision, as in JAX.
    """

    w: np.ndarray  # (2·NTS, 2·K) float32, interleaved output columns
    w_t: torch.Tensor
    nts: int
    k: int
    compute_dtype: torch.dtype = torch.float32
    precision: str = "highest"

    @classmethod
    def create(cls, cfg: RadarConfig, device: torch.device | str,
               compute_dtype: torch.dtype = torch.float32,
               precision: str | None = None) -> "PackedFastTime":
        """``precision`` defaults to ``cfg.algorithm.matmul_precision``."""
        m = build_fast_time_matrix(cfg)  # (K, NTS) complex
        k, nts = m.shape
        w = np.zeros((2 * nts, 2 * k), np.float32)
        w[0::2, 0::2] = m.real.T
        w[0::2, 1::2] = m.imag.T
        w[1::2, 0::2] = -m.imag.T
        w[1::2, 1::2] = m.real.T
        if precision is None:
            precision = cfg.algorithm.matmul_precision
        mxu_passes(precision)  # ValueError for an unknown name
        return cls(w=w, w_t=torch.as_tensor(w, device=device), nts=nts, k=k,
                   compute_dtype=compute_dtype, precision=precision)

    @functools.cached_property
    def w_terms(self) -> tuple[torch.Tensor, ...]:
        """``w_t`` split for ``precision``'s passes, once (utils/cplx.py::
        mxu_terms)."""
        return mxu_terms(self.w_t, self.precision)

    def _matmul(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., 2·NTS] @ W in compute_dtype operands, float32 sums and
        result; at float32 with ``precision``'s passes."""
        if self.compute_dtype == torch.float32:
            return precision_matmul(x, self.w_t, self.precision,
                                    b_terms=self.w_terms)
        pin_f32_matmul()
        return (x.to(self.compute_dtype).to(torch.float32)
                @ self.w_t.to(self.compute_dtype).to(torch.float32))

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
        x = self._flat_rows(raw)
        y = self._matmul(x).reshape(*x.shape[:-1], self.k, 2)
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
        indices. Gathers the 2·T weight columns per frame and recomputes at
        ``precision`` — never touches a [F, PN, K, 2] tensor.
        """
        f, t = idx.shape
        x = self._flat_rows(raw).reshape(f, -1, 2 * self.nts)  # [F, PN, 2NTS]
        cols = (idx.to(torch.int64)[..., None] * 2
                + torch.arange(2, device=idx.device)).reshape(f, 2 * t)
        w_sel = self.w_t.T[cols]  # [F, 2T, 2NTS]
        y = precision_matmul(x, w_sel.transpose(1, 2),
                             self.precision)  # [F, PN, 2T]
        y = y.reshape(f, x.shape[1], t, 2)
        off = self.offset(calib)[idx.to(torch.int64)]  # [F, T, 2]
        return y - off[:, None]


def range_profile(range_fft: torch.Tensor) -> torch.Tensor:
    """Non-coherent integration across chirps (radar_processing.m:210): the
    max over chirps of |range FFT|, which is MATLAB's abs(max(X, [], 2)).

    range_fft: [..., PN, K, 2] → profile [..., K] float32.
    """
    return pair_abs(range_fft).amax(dim=-2)
