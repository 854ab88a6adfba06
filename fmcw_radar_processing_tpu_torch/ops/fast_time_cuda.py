"""K1 and K6: fused fast-time range DFT + magnitude + max over chirps.

Two wrappers over the kernel of ``csrc/fast_time_profile.cu``:

  K1 :func:`fast_time_profile` — the profile [F, K] only (replaces the JAX
     package's Pallas ``ops/fast_time_pallas.py::_profile_kernel_b3`` and
     ``_profile_kernel``);
  K6 :func:`fast_time` — the range FFT [F, PN, K, 2] stored as well
     (replaces ``ops/fast_time_pallas.py::_kernel``, impl "pallas").

Each launches its kernel for CUDA tensors and runs its plain PyTorch
version (:func:`fast_time_profile_ref`, :func:`fast_time_ref`) for CPU
tensors. Neither falls back: on a CUDA tensor it launches or raises.

The kernel takes the BLOCKED packed weight of
:func:`_packed_blocked_weight` (columns [:K] give the real part of each
bin, [K:] the imaginary part), not ``PackedFastTime.w``'s interleaved
columns. It computes at exact float32, which meets both precision classes
of the TPU kernels ("high" = bf16x3 and "highest").
"""

from __future__ import annotations

import numpy as np
import torch

from fmcw_radar_processing_tpu.config import RadarConfig
from fmcw_radar_processing_tpu_torch.dsp.fast_time import (
    build_fast_time_matrix,
    range_profile,
)
from fmcw_radar_processing_tpu_torch.ops import _lib
from fmcw_radar_processing_tpu_torch.utils.cplx import pin_f32_matmul

KERNEL_PN = 16  # chirps per frame the kernel is built for
KERNEL_IN = 128  # 2·NTS
KERNEL_BIN_TILE = 64  # K must be a multiple of this


def _packed_blocked_weight(m) -> np.ndarray:
    """[2·NTS, 2·K] real weight with re|im BLOCK columns (cols [:K] give the
    real part, [K:] the imaginary part), for interleaved-pair input rows."""
    k, nts = m.shape
    w = np.zeros((2 * nts, 2 * k), np.float32)
    w[0::2, :k] = m.real.T
    w[1::2, :k] = -m.imag.T
    w[0::2, k:] = m.imag.T
    w[1::2, k:] = m.real.T
    return w


def blocked_weight(cfg: RadarConfig,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """The blocked packed weight [2·NTS, 2·K] float32 on ``device``."""
    return torch.as_tensor(_packed_blocked_weight(build_fast_time_matrix(cfg)),
                           device=device)


def calib_offset(calib: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """off = calib · W [2·K] at exact float32 (calib: [NTS, 2] pair)."""
    pin_f32_matmul()
    return (calib.to(torch.float32).reshape(1, -1) @ w).reshape(-1)


def fast_time_profile_ref(x: torch.Tensor, w: torch.Tensor, off: torch.Tensor,
                          pn: int) -> torch.Tensor:
    """Plain version: x [F·PN, 2·NTS] @ W − off, |·|, max over the PN chirps
    of each frame → profile [F, K]."""
    pin_f32_matmul()
    k = w.shape[1] // 2
    y = x @ w - off
    mag = torch.sqrt(y[:, :k] * y[:, :k] + y[:, k:] * y[:, k:])
    return mag.reshape(-1, pn, k).amax(dim=1)


def fast_time_ref(x: torch.Tensor, w: torch.Tensor, off: torch.Tensor,
                  pn: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6: (rf [F, PN, K, 2] with (re, im) pairs, profile
    [F, K]) of flat pair rows x [F·PN, 2·NTS]."""
    pin_f32_matmul()
    k = w.shape[1] // 2
    y = x @ w - off
    rf = torch.stack([y[:, :k], y[:, k:]], dim=-1).reshape(-1, pn, k, 2)
    return rf, range_profile(rf)


def _check(x: torch.Tensor, w: torch.Tensor, off: torch.Tensor, pn: int):
    if pn != KERNEL_PN:
        raise ValueError(f"the fast-time kernel takes PN={KERNEL_PN}, "
                         f"got {pn}")
    rows, n_in = x.shape
    k2 = w.shape[1]
    if n_in != KERNEL_IN or w.shape[0] != KERNEL_IN:
        raise ValueError(f"the fast-time kernel takes 2·NTS={KERNEL_IN}, "
                         f"got x {tuple(x.shape)}, w {tuple(w.shape)}")
    if k2 % (2 * KERNEL_BIN_TILE) or off.shape != (k2,):
        raise ValueError(f"K must be a multiple of {KERNEL_BIN_TILE}; "
                         f"w {tuple(w.shape)}, off {tuple(off.shape)}")
    if rows % pn:
        raise ValueError(f"rows {rows} are not whole frames of {pn} chirps")
    for name, t in (("x", x), ("w", w), ("off", off)):
        _lib.check_operand(name, t, x.device, torch.float32)


def fast_time_profile(x: torch.Tensor, w: torch.Tensor, off: torch.Tensor,
                      pn: int) -> torch.Tensor:
    """Range profile [F, K] of flat pair rows x [F·PN, 2·NTS].

    CPU tensors: the plain version. CUDA tensors: the K1 kernel.
    """
    if x.device.type == "cpu":
        return fast_time_profile_ref(x, w, off, pn)
    lib = _lib.load_kernels()
    _check(x, w, off, pn)
    rows = x.shape[0]
    k = w.shape[1] // 2
    prof = torch.empty((rows // pn, k), dtype=torch.float32, device=x.device)
    if rows == 0:
        return prof
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fast_time_profile_launch(x.data_ptr(), w.data_ptr(),
                                      off.data_ptr(), prof.data_ptr(), rows, k,
                                      stream)
    _lib.check_launch("fast_time_profile", rc)
    return prof


def fast_time(x: torch.Tensor, w: torch.Tensor, off: torch.Tensor,
              pn: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Range FFT [F, PN, K, 2] and profile [F, K] of flat pair rows
    x [F·PN, 2·NTS].

    CPU tensors: the plain version. CUDA tensors: the K6 kernel.
    """
    if x.device.type == "cpu":
        return fast_time_ref(x, w, off, pn)
    lib = _lib.load_kernels()
    _check(x, w, off, pn)
    rows = x.shape[0]
    k = w.shape[1] // 2
    prof = torch.empty((rows // pn, k), dtype=torch.float32, device=x.device)
    rf = torch.empty((rows // pn, pn, k, 2), dtype=torch.float32,
                     device=x.device)
    if rows == 0:
        return rf, prof
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fast_time_launch(x.data_ptr(), w.data_ptr(), off.data_ptr(),
                              prof.data_ptr(), rf.data_ptr(), rows, k, stream)
    _lib.check_launch("fast_time", rc)
    return rf, prof
