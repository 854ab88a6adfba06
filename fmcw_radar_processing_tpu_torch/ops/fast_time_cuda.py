"""K1a, K1b, K1c and K6: fused fast-time range DFT + magnitude + max over
chirps, all on the tensor cores (``csrc/fast_time_wgmma.cu``: K1a, K1b and
K6 one kernel template on the number of bf16 passes, K1c a persistent
kernel fed by TMA whose launch geometry :func:`k1c_geometry` computes).

Four wrappers:

  K1a :func:`fast_time_profile_b3` — the profile [F, K] only, as the bf16x3
      product (replaces the JAX package's Pallas
      ``ops/fast_time_pallas.py::_profile_kernel_b3``, impl
      "pallas_profile_high", the production class);
  K1b :func:`fast_time_profile` — the same profile as six bf16 passes, the
      TPU's ``Precision.HIGHEST`` (replaces ``_profile_kernel``, impl
      "pallas_profile", the HIGHEST class);
  K1c :func:`fast_time_profile_bf16` — the same profile as one bf16 pass
      (replaces ``_profile_kernel`` at ``Precision.DEFAULT``, impl
      "pallas_profile_bf16");
  K6  :func:`fast_time` — K1b's six passes storing the range FFT [F, PN, K,
      2] as well (replaces ``ops/fast_time_pallas.py::_kernel``, impl
      "pallas").

Each launches its kernel for CUDA tensors and runs a plain PyTorch version
for CPU tensors: K1a and K1c their own arithmetic
(:func:`fast_time_profile_b3_ref`, :func:`fast_time_profile_bf16_ref`);
K1b and K6 the exact float32 product (:func:`fast_time_profile_ref`,
:func:`fast_time_ref`), as the JAX package's interpret mode computes
HIGHEST exactly on the CPU. Their six-pass plain versions
(:func:`fast_time_profile_b6_ref`, :func:`fast_time_b6_ref`) repeat the
kernel's arithmetic and are the kernels' yardstick on the card. None falls
back: on a CUDA tensor it launches or raises.

The kernels take the BLOCKED packed weight of
:func:`_packed_blocked_weight` (columns [:K] give the real part of each
bin, [K:] the imaginary part), not ``PackedFastTime.w``'s interleaved
columns; K1a takes it split into bf16 halves by :func:`split_bf16x3`, K1c
the high half alone, K1b and K6 the float32 weight, which the kernel
splits into :func:`split_bf16x6`'s three terms itself.
"""

from __future__ import annotations

import numpy as np
import torch

from fmcw_radar_processing_tpu_torch.config import RadarConfig
from fmcw_radar_processing_tpu_torch.dsp.fast_time import (
    build_fast_time_matrix,
    range_profile,
)
from fmcw_radar_processing_tpu_torch.ops import _lib
from fmcw_radar_processing_tpu_torch.utils.cplx import pin_f32_matmul

KERNEL_PN = 16  # chirps per frame the kernel is built for
KERNEL_IN = 128  # 2·NTS
KERNEL_BIN_TILE = 64  # K must be a multiple of this
K1C_ROW_TILE = 64  # rows of x a K1c tile: four frames
K1C_GROUP_BINS = 256  # bins one K1c block owns at most


def k1c_geometry(rows: int, k: int,
                 sms: int) -> tuple[tuple[int, int, int, int], ...]:
    """K1c's launches, each ``(bin0, group_bins, groups, blocks)``, for
    ``rows`` rows of x, ``k`` bins (a multiple of 64) and ``sms`` SMs.

    Block (b, g) of a launch owns the ``group_bins`` bins from
    ``bin0 + g·group_bins`` and walks the 64-row tiles ``b, b + blocks,
    b + 2·blocks, ...`` of x. The 256-bin groups go in one launch and the
    narrower rest of K in a second, which runs after it on the same stream:
    each launch has one block per SM in all, and no more blocks than
    tiles."""
    row_tiles = -(-rows // K1C_ROW_TILE)
    full, rest = divmod(k, K1C_GROUP_BINS)
    launches = []
    if full:
        launches.append((0, K1C_GROUP_BINS, full,
                         max(1, min(row_tiles, sms // full))))
    if rest:
        launches.append((k - rest, rest, 1, max(1, min(row_tiles, sms))))
    return tuple(launches)


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
                   device: torch.device | str) -> torch.Tensor:
    """The blocked packed weight [2·NTS, 2·K] float32 on ``device``."""
    return torch.as_tensor(_packed_blocked_weight(build_fast_time_matrix(cfg)),
                           device=device)


def calib_offset(calib: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """off = calib · W [2·K] at exact float32 (calib: [NTS, 2] pair)."""
    pin_f32_matmul()
    return (calib.to(torch.float32).reshape(1, -1) @ w).reshape(-1)


def split_bf16x3(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(w_hi, w_lo) bf16 on w's device: w_hi = bf16(w), w_lo = bf16(w −
    w_hi), both round to nearest even — the TPU kernel's weight split."""
    w_hi = w.to(torch.bfloat16)
    return w_hi, (w - w_hi.to(torch.float32)).to(torch.bfloat16)


def split_bf16x6(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """(t1, t2, t3) bf16 on t's device: t1 = bf16(t), t2 = bf16(t − t1),
    t3 = bf16(t − t1 − t2), round to nearest even, the remainders exact in
    float32 — the three terms of the six-pass product, as K1b and K6 split
    x and W. For normal float32 values whose remainders stay normal,
    t1 + t2 + t3 == t exactly (24 bits in three 8-bit terms)."""
    t1 = t.to(torch.bfloat16)
    r1 = t - t1.to(torch.float32)
    t2 = r1.to(torch.bfloat16)
    return t1, t2, (r1 - t2.to(torch.float32)).to(torch.bfloat16)


def _b6_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x·W as the six bf16 passes of K1b/K6: the five correction products
    x1·w2 + x2·w1 + x1·w3 + x2·w2 + x3·w1 first, then x1·w1, each a float32
    matmul of the bf16 terms (every product exact in float32)."""
    pin_f32_matmul()
    x1, x2, x3 = (a.to(torch.float32) for a in split_bf16x6(x))
    w1, w2, w3 = (a.to(torch.float32) for a in split_bf16x6(w))
    return (x1 @ w2 + x2 @ w1 + x1 @ w3 + x2 @ w2 + x3 @ w1) + x1 @ w1


def fast_time_profile_b6_ref(x: torch.Tensor, w: torch.Tensor,
                             off: torch.Tensor, pn: int) -> torch.Tensor:
    """Plain version of K1b's kernel: the six-pass product of x [F·PN,
    2·NTS] and the float32 blocked weight w, minus off, |·| and the max
    over the PN chirps of each frame → profile [F, K]."""
    k = w.shape[1] // 2
    y = _b6_product(x, w) - off
    mag = torch.sqrt(y[:, :k] * y[:, :k] + y[:, k:] * y[:, k:])
    return mag.reshape(-1, pn, k).amax(dim=1)


def fast_time_b6_ref(x: torch.Tensor, w: torch.Tensor, off: torch.Tensor,
                     pn: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6's kernel: (rf [F, PN, K, 2], profile [F, K]) of
    the six-pass product."""
    k = w.shape[1] // 2
    y = _b6_product(x, w) - off
    rf = torch.stack([y[:, :k], y[:, k:]], dim=-1).reshape(-1, pn, k, 2)
    return rf, range_profile(rf)


def fast_time_profile_b3_ref(x: torch.Tensor, w_hi: torch.Tensor,
                             w_lo: torch.Tensor, off: torch.Tensor,
                             pn: int) -> torch.Tensor:
    """Plain version of K1a: x_hi = bf16(x), x_lo = bf16(x − x_hi), then
    x_hi·w_hi + x_lo·w_hi + x_hi·w_lo − off as three float32 matmuls
    (every product of two bf16 values is exact in float32), |·| and the
    max over the PN chirps of each frame → profile [F, K]."""
    pin_f32_matmul()
    k = w_hi.shape[1] // 2
    x_hi = x.to(torch.bfloat16).to(torch.float32)
    x_lo = (x - x_hi).to(torch.bfloat16).to(torch.float32)
    wh, wl = w_hi.to(torch.float32), w_lo.to(torch.float32)
    y = x_hi @ wh + x_lo @ wh + x_hi @ wl - off
    mag = torch.sqrt(y[:, :k] * y[:, :k] + y[:, k:] * y[:, k:])
    return mag.reshape(-1, pn, k).amax(dim=1)


def fast_time_profile_bf16_ref(x: torch.Tensor, w_hi: torch.Tensor,
                               off: torch.Tensor, pn: int) -> torch.Tensor:
    """Plain version of K1c: bf16(x)·w_hi − off as one float32 matmul of
    the bf16-rounded operands (every product exact in float32), |·| and the
    max over the PN chirps of each frame → profile [F, K]."""
    pin_f32_matmul()
    k = w_hi.shape[1] // 2
    y = x.to(torch.bfloat16).to(torch.float32) @ w_hi.to(torch.float32) - off
    mag = torch.sqrt(y[:, :k] * y[:, :k] + y[:, k:] * y[:, k:])
    return mag.reshape(-1, pn, k).amax(dim=1)


def fast_time_profile_ref(x: torch.Tensor, w: torch.Tensor, off: torch.Tensor,
                          pn: int) -> torch.Tensor:
    """The exact profile: x [F·PN, 2·NTS] @ W − off at float32, |·|, max
    over the PN chirps of each frame → profile [F, K] (K1b's CPU path)."""
    pin_f32_matmul()
    k = w.shape[1] // 2
    y = x @ w - off
    mag = torch.sqrt(y[:, :k] * y[:, :k] + y[:, k:] * y[:, k:])
    return mag.reshape(-1, pn, k).amax(dim=1)


def fast_time_ref(x: torch.Tensor, w: torch.Tensor, off: torch.Tensor,
                  pn: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact range FFT: (rf [F, PN, K, 2] with (re, im) pairs, profile
    [F, K]) of flat pair rows x [F·PN, 2·NTS] at float32 (K6's CPU
    path)."""
    pin_f32_matmul()
    k = w.shape[1] // 2
    y = x @ w - off
    rf = torch.stack([y[:, :k], y[:, k:]], dim=-1).reshape(-1, pn, k, 2)
    return rf, range_profile(rf)


def _check(x: torch.Tensor, w: torch.Tensor, off: torch.Tensor, pn: int,
           w_dtype: torch.dtype = torch.float32):
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
    for name, t in (("x", x), ("off", off)):
        _lib.check_operand(name, t, x.device, torch.float32)
    _lib.check_operand("w", w, x.device, w_dtype)


def fast_time_profile_b3(x: torch.Tensor, w_hi: torch.Tensor,
                         w_lo: torch.Tensor, off: torch.Tensor,
                         pn: int) -> torch.Tensor:
    """Range profile [F, K] of flat pair rows x [F·PN, 2·NTS], bf16x3 class.

    w_hi, w_lo: :func:`split_bf16x3` of the blocked weight. CPU tensors:
    the plain version. CUDA tensors: the K1a kernel.
    """
    if x.device.type == "cpu":
        return fast_time_profile_b3_ref(x, w_hi, w_lo, off, pn)
    lib = _lib.load_kernels()
    if w_lo.shape != w_hi.shape:
        raise ValueError(f"w_hi {tuple(w_hi.shape)} and w_lo "
                         f"{tuple(w_lo.shape)} differ")
    _check(x, w_hi, off, pn, torch.bfloat16)
    _lib.check_operand("w_lo", w_lo, x.device, torch.bfloat16)
    rows = x.shape[0]
    k = w_hi.shape[1] // 2
    prof = torch.empty((rows // pn, k), dtype=torch.float32, device=x.device)
    if rows == 0:
        return prof
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fast_time_profile_b3_launch(x.data_ptr(), w_hi.data_ptr(),
                                         w_lo.data_ptr(), off.data_ptr(),
                                         prof.data_ptr(), rows, k, stream)
    _lib.check_launch("fast_time_profile_b3", rc)
    return prof


def fast_time_profile_bf16(x: torch.Tensor, w_hi: torch.Tensor,
                           off: torch.Tensor, pn: int) -> torch.Tensor:
    """Range profile [F, K] of flat pair rows x [F·PN, 2·NTS], one bf16
    pass with float32 sums.

    w_hi: the high half of :func:`split_bf16x3` of the blocked weight. CPU
    tensors: the plain version. CUDA tensors: the K1c kernel.
    """
    if x.device.type == "cpu":
        return fast_time_profile_bf16_ref(x, w_hi, off, pn)
    lib = _lib.load_kernels()
    _check(x, w_hi, off, pn, torch.bfloat16)
    rows = x.shape[0]
    k = w_hi.shape[1] // 2
    prof = torch.empty((rows // pn, k), dtype=torch.float32, device=x.device)
    if rows == 0:
        return prof
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for launch in k1c_geometry(rows, k, _lib.sm_count(x.device)):
        rc = lib.fast_time_profile_bf16_launch(x.data_ptr(), w_hi.data_ptr(),
                                               off.data_ptr(), prof.data_ptr(),
                                               rows, k, *launch, stream)
        _lib.check_launch("fast_time_profile_bf16", rc)
    return prof


def fast_time_profile(x: torch.Tensor, w: torch.Tensor, off: torch.Tensor,
                      pn: int) -> torch.Tensor:
    """Range profile [F, K] of flat pair rows x [F·PN, 2·NTS], the HIGHEST
    class.

    w: the float32 blocked weight. CPU tensors: the exact float32 profile.
    CUDA tensors: the K1b kernel (six bf16 passes on the tensor cores).
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

    CPU tensors: the exact float32 product. CUDA tensors: the K6 kernel
    (K1b's six passes, the range FFT stored too).
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
