"""K2a/K2b/K3, K4a/K4b and the recompute pairs: the fused spectrogram
export (STFT → PSD → dB → log bins).

:func:`spectrogram` is the port of the JAX package's
``ops/stft_pallas.py::spectrogram_pallas``, hop 1. Phase 1 writes the
one-sided PSD [nb_pad, t_pad] of every sliding 20-sample window, columns
past the valid count zeroed, plus the max of the stored values per
1024-column tile, in one of two precision classes (``psd_precision``):

  K2a :func:`psd_phase1_b3` — "high", the bf16x3 form on the tensor cores
      (replaces ``_psd_kernel_b3``; nb_pad ≤ 512, JAX's untiled domain);
  K2b :func:`psd_phase1` — "highest", the exact float32 form up to nb_pad
      272 (replaces ``_psd_kernel``), and
  K4a :func:`psd_phase1_tiled` — the same above it, with one max per
      column tile and bin block (replaces ``_psd_kernel_tiled``). K2b is
      K4a's kernel, its maxima reduced per column tile.

Each can round the PSD to bf16 (``psd_store_dtype`` bfloat16, JAX's bf16
PSD store) before the max; the values stay in a float32 array. Phase 2,
by nb_pad:

  nb_pad ≤ 272 (nfft ≤ 512): K3 :func:`db_rescale` — dB map in the store
      dtype and the [1024, t_pad] log-frequency intensity in float32,
      bfloat16 or int8 (replaces ``_db_rescale_kernel``);
  any larger nb_pad: K4b :func:`db_rescale_tiled` — the same, over
      (column tile, 128-bin block) items (replaces
      ``_db_rescale_kernel_tiled``).

recompute=True, float32 dB map, exact — the PSD is never stored:
  nb_pad ≤ 272, K5a :func:`psd_tmax` — K2b's per-tile maxima only (K4a's
      kernel without its store; replaces ``_tmax_kernel``) and K5b
      :func:`db_rescale_recompute` — K3's kernel with each column tile's
      PSD recomputed by the same arithmetic instead of loaded, then K3's
      dB map and intensity, bit-equal to K2b → K3's (replaces
      ``_db_rescale_recompute_kernel``);
  272 < nb_pad ≤ 512, the same two TPU kernels as K4a without its store
      (:func:`psd_tmax_tiled`) and K4b with each bin block's PSD
      recomputed (:func:`db_rescale_recompute_tiled`), bit-equal to
      K4a → K4b's.

Between the phases a ``torch.amax`` of the maxima — the one cross-column
dependency of the global-max dB normalization — stays on the device.

Each wrapper runs its plain PyTorch version for CPU tensors and launches
its kernel (``csrc/stft_psd_b3.cu``, ``csrc/stft_export.cu``,
``csrc/stft_export_tiled.cu``), or raises, for CUDA tensors. K2a computes
the bf16x3 form, every other kernel exact float32; the plain versions
:func:`psd_phase1_b3_ref`, :func:`psd_phase1_ref` and
:func:`db_rescale_ref` compute every pair's function at any nb, and
:func:`psd_tmax_ref` and :func:`db_rescale_recompute_ref` are built on
them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from fmcw_radar_processing_tpu_torch.dsp.stft import (
    DB_FLOOR,
    INT8_DB_RANGE,
    INT8_SCALE,
    LN10_INV_20,
    StftOperator,
    log_interp,
    psd_db,
    quantize_db_int8,
)
from fmcw_radar_processing_tpu_torch.ops import _lib
from fmcw_radar_processing_tpu_torch.utils.cplx import pin_f32_matmul

PSD_TILE = 1024  # columns per K2 and K4a block; t_pad is a multiple of it
DB_TILE = 64  # columns per K3 tile
DB_TILED_TILE = 64  # columns per K4b work item
BIN_BLOCK = 128  # bins per K4a/K4b bin block
B3_WARP_COLS = 32  # columns per K2a warp tile: one max each
WINDOW = 20  # the window length the kernels are built for
# nb_pad ceiling of the untiled kernels: nfft 512 under the bf16 store's
# 16-alignment. K3 keeps two nb_pad × 64 float32 dB tiles in shared memory
# (139 KB here; 227 KB is the most a block may have). Past it,
# :func:`spectrogram` takes the bin-blocked pairs.
UNTILED_MAX_BINS = 272
# nb_pad ceiling of the JAX package's untiled export path, where alone it
# runs the recompute formulation, the bf16x3 phase 1 ("high") and the bf16
# stores: the port takes all four up to here as well (K2a is built for it).
JAX_UNTILED_MAX_BINS = 512
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _folded_operator(op: StftOperator, align: int = 8) -> np.ndarray:
    """[2·nb_pad, W] stacked re/im DFT operator with √(scale·dbl) folded
    into each row pair (so the PSD is a pure square-add), zero-padded so
    nb_pad is a multiple of ``align`` (8, or 16 for a bfloat16 dB store)."""
    nb = op.num_bins
    dbl = np.full(nb, 2.0, np.float32)
    dbl[0] = 1.0
    if op.nfft % 2 == 0:
        dbl[-1] = 1.0
    c = np.sqrt(op.scale * dbl).astype(np.float32)[:, None]
    nb_pad = -(-nb // align) * align
    a2 = np.zeros((2 * nb_pad, op.window_length), np.float32)
    a2[:nb] = op.a_re * c
    a2[nb_pad : nb_pad + nb] = op.a_im * c
    return a2


@functools.lru_cache(maxsize=8)
def _log_interp_gather(nb: int, num_bins: int):
    """(i0 int32, w0 f32, w1 f32) [num_bins]: the two nonzeros of each row
    of ``dsp.stft._log_interp_matrix``, at columns i0 and i0 + 1, computed
    as it computes them but without the dense [num_bins, nb] matrix."""
    pos = np.logspace(0.0, np.log10(nb - 1), num_bins)
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, nb - 2)
    frac = pos - i0
    return (i0.astype(np.int32), (1.0 - frac).astype(np.float32),
            frac.astype(np.float32))


def _bin_block_rows(nb: int, num_bins: int, nb_pad: int,
                    kb: int = BIN_BLOCK) -> np.ndarray:
    """[ceil(nb_pad / kb) + 1] int32 row ranges of K4b: the output rows o
    with kb·k ≤ i0[o] < kb·(k + 1) are o_start[k] ≤ o < o_start[k + 1]
    (i0 is nondecreasing, so they are contiguous); o_start[-1] = num_bins."""
    i0 = _log_interp_gather(nb, num_bins)[0]
    edges = np.arange(-(-nb_pad // kb) + 1, dtype=np.int64) * kb
    return np.searchsorted(i0, edges, side="left").astype(np.int32)


def _psd_epilogue(s2: torch.Tensor, nv: int, nb_pad: int, t_pad: int,
                  round_bf16: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """p = re² + im² of the stacked [2·nb_pad, t_pad] products, zero at
    columns ≥ nv, rounded to bf16 (and widened back) with ``round_bf16``;
    tmax is the max of those stored values per PSD_TILE columns."""
    p = s2[:nb_pad] ** 2 + s2[nb_pad:] ** 2
    col = torch.arange(t_pad, device=s2.device)
    p = torch.where(col < nv, p, 0.0)
    if round_bf16:
        p = p.to(torch.bfloat16).to(torch.float32)
    tmax = p.reshape(nb_pad, t_pad // PSD_TILE, PSD_TILE).amax(dim=(0, 2))
    return p, tmax


def _padded_signal(sig: torch.Tensor, wl: int, t_pad: int) -> torch.Tensor:
    return F.pad(sig.to(torch.float32), (0, t_pad + wl - 1 - sig.shape[0]))


def psd_phase1_ref(sig: torch.Tensor, nv: int, a2: torch.Tensor, nb_pad: int,
                   t_pad: int, round_bf16: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2b and K4a (im2col by ``unfold`` + one float32
    matmul), at any nb_pad: the exact form (``psd_precision="highest"``).

    sig: [L] float32 with L − W + 1 ≤ t_pad; nv: valid column count;
    round_bf16: the bf16 PSD store's rounding (JAX's ``psd_store_dtype``
    bfloat16), before the max. Returns (p [nb_pad, t_pad], tmax [t_pad /
    PSD_TILE]); K4a's tmax is cut finer (per bin block too) but has the
    same max."""
    pin_f32_matmul()
    wl = a2.shape[1]
    frames = _padded_signal(sig, wl, t_pad).unfold(0, wl, 1).T  # [W, t_pad]
    return _psd_epilogue(a2 @ frames, nv, nb_pad, t_pad, round_bf16)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def psd_phase1_b3_ref(sig: torch.Tensor, nv: int, a2: torch.Tensor,
                      nb_pad: int, t_pad: int, round_bf16: bool = False
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2a, the bf16x3 form (``psd_precision="high"``):
    a2_hi = bf16(a2), a2_lo = bf16(a2 − a2_hi), x_hi = bf16(x), x_lo =
    bf16(x − x_hi), then a2_hi·x_hi + a2_hi·x_lo + a2_lo·x_hi as three
    float32 matmuls of the bf16-rounded operands (every product exact in
    float32), the square-add, the mask and the optional bf16 rounding.
    Arguments and results as :func:`psd_phase1_ref`."""
    pin_f32_matmul()
    wl = a2.shape[1]
    a_hi = _bf16(a2)
    a_lo = _bf16(a2 - a_hi)
    x = _padded_signal(sig, wl, t_pad)
    x_hi = _bf16(x)
    x_lo = _bf16(x - x_hi)
    f_hi = x_hi.unfold(0, wl, 1).T  # [W, t_pad]
    f_lo = x_lo.unfold(0, wl, 1).T
    s2 = a_hi @ f_hi + a_hi @ f_lo + a_lo @ f_hi
    return _psd_epilogue(s2, nv, nb_pad, t_pad, round_bf16)


def _check_untiled(nb_pad: int) -> None:
    if nb_pad > UNTILED_MAX_BINS:
        raise ValueError(
            f"the untiled export kernels take nb_pad ≤ {UNTILED_MAX_BINS}, "
            f"got {nb_pad}: use psd_phase1_tiled and db_rescale_tiled")


def _check_phase1_operands(sig: torch.Tensor, a2: torch.Tensor, nb_pad: int,
                           t_pad: int) -> None:
    """What K2a and K4a both take."""
    _lib.check_operand("sig", sig, sig.device, torch.float32)
    _lib.check_operand("a2", a2, sig.device, torch.float32)
    if sig.ndim != 1 or a2.shape != (2 * nb_pad, WINDOW):
        raise ValueError(f"the PSD kernels take sig [L] and a2 [2·nb_pad, "
                         f"{WINDOW}], got {tuple(sig.shape)}, "
                         f"{tuple(a2.shape)}")
    if t_pad % PSD_TILE or sig.shape[0] - WINDOW + 1 > t_pad:
        raise ValueError(f"t_pad {t_pad} must be a multiple of {PSD_TILE} "
                         f"covering L − {WINDOW - 1} = "
                         f"{sig.shape[0] - WINDOW + 1} columns")


def _launch_psd_tiled(name: str, sig: torch.Tensor, nv: int,
                      a2: torch.Tensor, nb_pad: int, t_pad: int,
                      round_bf16: bool = False, store: bool = True):
    """K4a's kernel (``csrc/stft_export_tiled.cu``) on CUDA tensors, its
    launch counted under ``name``: (p [nb_pad, t_pad], or None without
    ``store``; tmax [ceil(nb_pad / BIN_BLOCK) · t_pad / PSD_TILE], bin
    block major)."""
    lib = _lib.load_kernels()
    _check_phase1_operands(sig, a2, nb_pad, t_pad)
    p = (torch.empty((nb_pad, t_pad), dtype=torch.float32, device=sig.device)
         if store else None)
    tmax = torch.empty(-(-nb_pad // BIN_BLOCK) * (t_pad // PSD_TILE),
                       dtype=torch.float32, device=sig.device)
    stream = torch.cuda.current_stream(sig.device).cuda_stream
    if store:
        rc = lib.psd_phase1_tiled_launch(sig.data_ptr(), sig.shape[0],
                                         a2.data_ptr(), nb_pad, p.data_ptr(),
                                         tmax.data_ptr(), t_pad, nv,
                                         int(round_bf16), stream)
    else:
        rc = lib.psd_tmax_tiled_launch(sig.data_ptr(), sig.shape[0],
                                       a2.data_ptr(), nb_pad, tmax.data_ptr(),
                                       t_pad, nv, stream)
    _lib.check_launch(name, rc)
    return p, tmax


def _tile_max(tmax: torch.Tensor, t_pad: int) -> torch.Tensor:
    """K4a's maxima, one per bin block and column tile, as one per column
    tile [t_pad / PSD_TILE]."""
    return tmax.reshape(-1, t_pad // PSD_TILE).amax(dim=0)


def psd_phase1(sig: torch.Tensor, nv: int, a2: torch.Tensor, nb_pad: int,
               t_pad: int, round_bf16: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2b, the exact form up to nb_pad UNTILED_MAX_BINS. CPU tensors: the
    plain version; CUDA tensors: K4a's kernel, its maxima reduced to one
    per column tile. Arguments and results as :func:`psd_phase1_ref`."""
    if sig.device.type == "cpu":
        return psd_phase1_ref(sig, nv, a2, nb_pad, t_pad, round_bf16)
    p, tmax = _launch_psd_tiled("psd_phase1", sig, nv, a2, nb_pad, t_pad,
                                round_bf16)
    return p, _tile_max(tmax, t_pad)


def psd_phase1_tiled(sig: torch.Tensor, nv: int, a2: torch.Tensor,
                     nb_pad: int, t_pad: int, round_bf16: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4a, any nb_pad. CPU tensors: the plain version; CUDA tensors: the
    kernel. Returns (p [nb_pad, t_pad], tmax [ceil(nb_pad / BIN_BLOCK) ·
    t_pad / PSD_TILE]); round_bf16 as :func:`psd_phase1_ref`."""
    if sig.device.type == "cpu":
        return psd_phase1_ref(sig, nv, a2, nb_pad, t_pad, round_bf16)
    return _launch_psd_tiled("psd_phase1_tiled", sig, nv, a2, nb_pad, t_pad,
                             round_bf16)


def psd_phase1_b3(sig: torch.Tensor, nv: int, a2: torch.Tensor, nb_pad: int,
                  t_pad: int, round_bf16: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2a, the bf16x3 form, nb_pad ≤ JAX_UNTILED_MAX_BINS. CPU tensors: the
    plain version; CUDA tensors: the kernel (``csrc/stft_psd_b3.cu``, on
    the tensor cores), which splits the exact operator a2 itself.
    Arguments and results as :func:`psd_phase1_ref`."""
    if sig.device.type == "cpu":
        return psd_phase1_b3_ref(sig, nv, a2, nb_pad, t_pad, round_bf16)
    lib = _lib.load_kernels()
    if nb_pad > JAX_UNTILED_MAX_BINS or nb_pad % 8:
        raise ValueError(f"K2a takes nb_pad a multiple of 8 up to "
                         f"{JAX_UNTILED_MAX_BINS}, got {nb_pad}")
    _check_phase1_operands(sig, a2, nb_pad, t_pad)
    p = torch.empty((nb_pad, t_pad), dtype=torch.float32, device=sig.device)
    # One max per warp tile of the kernel, reduced here per column tile.
    tmax = torch.empty(t_pad // B3_WARP_COLS, dtype=torch.float32,
                       device=sig.device)
    stream = torch.cuda.current_stream(sig.device).cuda_stream
    rc = lib.psd_phase1_b3_launch(sig.data_ptr(), sig.shape[0], a2.data_ptr(),
                                  nb_pad, p.data_ptr(), tmax.data_ptr(), t_pad,
                                  nv, int(round_bf16), stream)
    _lib.check_launch("psd_phase1_b3", rc)
    return p, tmax.reshape(-1, PSD_TILE // B3_WARP_COLS).amax(dim=1)


def psd_tmax_ref(sig: torch.Tensor, nv: int, a2: torch.Tensor, nb_pad: int,
                 t_pad: int) -> torch.Tensor:
    """Plain version of K5a: the tmax [t_pad / PSD_TILE] of
    :func:`psd_phase1_ref`."""
    return psd_phase1_ref(sig, nv, a2, nb_pad, t_pad)[1]


def psd_tmax(sig: torch.Tensor, nv: int, a2: torch.Tensor, nb_pad: int,
             t_pad: int) -> torch.Tensor:
    """K5a: K2b's per-tile PSD maxima [t_pad / PSD_TILE] without the PSD.
    CPU tensors: the plain version; CUDA tensors: K4a's kernel without its
    store, its maxima reduced to one per column tile."""
    if sig.device.type == "cpu":
        return psd_tmax_ref(sig, nv, a2, nb_pad, t_pad)
    return _tile_max(_launch_psd_tiled("psd_tmax", sig, nv, a2, nb_pad, t_pad,
                                       store=False)[1], t_pad)


def psd_tmax_tiled(sig: torch.Tensor, nv: int, a2: torch.Tensor, nb_pad: int,
                   t_pad: int) -> torch.Tensor:
    """K4a's tmax without the PSD (the recompute export past nb_pad 272).
    CPU tensors: the plain version; CUDA tensors: the kernel. Returns tmax
    [ceil(nb_pad / BIN_BLOCK) · t_pad / PSD_TILE] (the plain version's is
    cut per column tile only, with the same max)."""
    if sig.device.type == "cpu":
        return psd_tmax_ref(sig, nv, a2, nb_pad, t_pad)
    return _launch_psd_tiled("psd_tmax_tiled", sig, nv, a2, nb_pad, t_pad,
                             store=False)[1]


def _emit_intensity(acc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Intensity in the output dtype; int8 is the affine dB code over
    INT8_DB_RANGE, round half to even, clamped (as the kernel emits it)."""
    if dtype == torch.int8:
        return quantize_db_int8(acc)
    return acc.to(dtype)


def db_rescale_ref(p: torch.Tensor, gmax: torch.Tensor, nb: int,
                   num_bins: int, db_dtype: torch.dtype,
                   int_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3 and K4b, at any nb: dB map, then the dense
    [num_bins, nb−1] float32 interpolation plus the Nyquist rank-1 term,
    consuming the float32 dB."""
    db = psd_db(p, gmax)
    return db.to(db_dtype), _emit_intensity(log_interp(db[:nb], num_bins),
                                            int_dtype)


@functools.lru_cache(maxsize=8)
def _gather_tables(nb: int, num_bins: int, device: torch.device):
    return tuple(torch.as_tensor(a, device=device)
                 for a in _log_interp_gather(nb, num_bins))


@functools.lru_cache(maxsize=8)
def _bin_block_table(nb: int, num_bins: int, nb_pad: int,
                     device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_bin_block_rows(nb, num_bins, nb_pad), device=device)


def _check_gmax(gmax: torch.Tensor, device: torch.device) -> None:
    if gmax.device != device or gmax.dtype != torch.float32 or gmax.numel() != 1:
        raise ValueError(f"gmax must be one float32 on {device}")


def _check_phase2_operands(p: torch.Tensor, gmax: torch.Tensor, nb: int,
                           db_dtype: torch.dtype, int_dtype: torch.dtype,
                           col_tile: int) -> None:
    """What K3 and K4b both take."""
    _lib.check_operand("p", p, p.device, torch.float32)
    _check_gmax(gmax, p.device)
    nb_pad, t_pad = p.shape
    if t_pad % col_tile or not 2 <= nb <= nb_pad:
        raise ValueError(f"the dB kernels take t_pad % {col_tile} == 0 and "
                         f"2 ≤ nb ≤ nb_pad; got p {tuple(p.shape)}, nb {nb}")
    if db_dtype not in (torch.float32, torch.bfloat16) or int_dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported store dtypes {db_dtype}, {int_dtype}")


def db_rescale(p: torch.Tensor, gmax: torch.Tensor, nb: int, num_bins: int,
               db_dtype: torch.dtype,
               int_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """K3. CPU tensors: the plain version; CUDA tensors: the kernel.

    p: [nb_pad, t_pad] float32 PSD; gmax: one float32 on p's device.
    Returns (db [nb_pad, t_pad] db_dtype, intensity [num_bins, t_pad])."""
    if p.device.type == "cpu":
        return db_rescale_ref(p, gmax, nb, num_bins, db_dtype, int_dtype)
    lib = _lib.load_kernels()
    nb_pad, t_pad = p.shape
    _check_untiled(nb_pad)
    _check_phase2_operands(p, gmax, nb, db_dtype, int_dtype, DB_TILE)
    i0, w0, w1 = _gather_tables(nb, num_bins, p.device)
    db = torch.empty((nb_pad, t_pad), dtype=db_dtype, device=p.device)
    out = torch.empty((num_bins, t_pad), dtype=int_dtype, device=p.device)
    gmax = gmax.reshape(1).contiguous()
    stream = torch.cuda.current_stream(p.device).cuda_stream
    rc = lib.db_rescale_launch(
        p.data_ptr(), gmax.data_ptr(), i0.data_ptr(), w0.data_ptr(),
        w1.data_ptr(), nb_pad, t_pad, num_bins, db.data_ptr(),
        _DTYPE_CODE[db_dtype], out.data_ptr(), _DTYPE_CODE[int_dtype],
        LN10_INV_20, DB_FLOOR, INT8_DB_RANGE[0], INT8_SCALE, stream)
    _lib.check_launch("db_rescale", rc)
    return db, out


def db_rescale_tiled(p: torch.Tensor, gmax: torch.Tensor, nb: int,
                     num_bins: int, db_dtype: torch.dtype,
                     int_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """K4b, any nb_pad: the function of K3. CPU tensors: the plain version;
    CUDA tensors: the kernel."""
    if p.device.type == "cpu":
        return db_rescale_ref(p, gmax, nb, num_bins, db_dtype, int_dtype)
    lib = _lib.load_kernels()
    nb_pad, t_pad = p.shape
    _check_phase2_operands(p, gmax, nb, db_dtype, int_dtype, DB_TILED_TILE)
    i0, w0, w1 = _gather_tables(nb, num_bins, p.device)
    o_start = _bin_block_table(nb, num_bins, nb_pad, p.device)
    db = torch.empty((nb_pad, t_pad), dtype=db_dtype, device=p.device)
    out = torch.empty((num_bins, t_pad), dtype=int_dtype, device=p.device)
    gmax = gmax.reshape(1).contiguous()
    stream = torch.cuda.current_stream(p.device).cuda_stream
    rc = lib.db_rescale_tiled_launch(
        p.data_ptr(), gmax.data_ptr(), i0.data_ptr(), w0.data_ptr(),
        w1.data_ptr(), o_start.data_ptr(), nb_pad, t_pad, db.data_ptr(),
        _DTYPE_CODE[db_dtype], out.data_ptr(), _DTYPE_CODE[int_dtype],
        LN10_INV_20, DB_FLOOR, INT8_DB_RANGE[0], INT8_SCALE, stream)
    _lib.check_launch("db_rescale_tiled", rc)
    return db, out


def db_rescale_recompute_ref(sig: torch.Tensor, nv: int, a2: torch.Tensor,
                             gmax: torch.Tensor, nb: int, num_bins: int,
                             t_pad: int, int_dtype: torch.dtype
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5b: :func:`psd_phase1_ref`'s PSD, then
    :func:`db_rescale_ref` with a float32 dB map."""
    p = psd_phase1_ref(sig, nv, a2, a2.shape[0] // 2, t_pad)[0]
    return db_rescale_ref(p, gmax, nb, num_bins, torch.float32, int_dtype)


def db_rescale_recompute(sig: torch.Tensor, nv: int, a2: torch.Tensor,
                         gmax: torch.Tensor, nb: int, num_bins: int,
                         t_pad: int, int_dtype: torch.dtype
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """K5b. CPU tensors: the plain version; CUDA tensors: K3's kernel
    recomputing each tile's PSD from the signal.

    sig, nv, a2, t_pad as :func:`psd_phase1`; gmax: one float32 on sig's
    device. Returns (db [nb_pad, t_pad] float32, intensity [num_bins,
    t_pad] int_dtype)."""
    if sig.device.type == "cpu":
        return db_rescale_recompute_ref(sig, nv, a2, gmax, nb, num_bins, t_pad,
                                        int_dtype)
    lib = _lib.load_kernels()
    nb_pad = a2.shape[0] // 2
    _check_untiled(nb_pad)
    _check_recompute_operands(sig, a2, gmax, nb, nb_pad, t_pad, int_dtype)
    i0, w0, w1 = _gather_tables(nb, num_bins, sig.device)
    db = torch.empty((nb_pad, t_pad), dtype=torch.float32, device=sig.device)
    out = torch.empty((num_bins, t_pad), dtype=int_dtype, device=sig.device)
    gmax = gmax.reshape(1).contiguous()
    stream = torch.cuda.current_stream(sig.device).cuda_stream
    rc = lib.db_rescale_recompute_launch(
        sig.data_ptr(), sig.shape[0], a2.data_ptr(), nb_pad, nv,
        gmax.data_ptr(), i0.data_ptr(), w0.data_ptr(), w1.data_ptr(), t_pad,
        num_bins, db.data_ptr(), out.data_ptr(), _DTYPE_CODE[int_dtype],
        LN10_INV_20, DB_FLOOR, INT8_DB_RANGE[0], INT8_SCALE, stream)
    _lib.check_launch("db_rescale_recompute", rc)
    return db, out


def _check_recompute_operands(sig: torch.Tensor, a2: torch.Tensor,
                              gmax: torch.Tensor, nb: int, nb_pad: int,
                              t_pad: int, int_dtype: torch.dtype) -> None:
    """What K5b and db_rescale_recompute_tiled both take."""
    _check_phase1_operands(sig, a2, nb_pad, t_pad)
    _check_gmax(gmax, sig.device)
    if not 2 <= nb <= nb_pad or int_dtype not in _DTYPE_CODE:
        raise ValueError(f"the recompute kernels take 2 ≤ nb ≤ nb_pad and "
                         f"intensity in {list(_DTYPE_CODE)}; got nb {nb}, "
                         f"nb_pad {nb_pad}, {int_dtype}")


def db_rescale_recompute_tiled(sig: torch.Tensor, nv: int, a2: torch.Tensor,
                               gmax: torch.Tensor, nb: int, num_bins: int,
                               t_pad: int, int_dtype: torch.dtype
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4b with each bin block's PSD recomputed from the signal by K4a's
    arithmetic (the recompute export past nb_pad 272). CPU tensors: the
    plain version of K5b; CUDA tensors: the kernel. Arguments and results
    as :func:`db_rescale_recompute`."""
    if sig.device.type == "cpu":
        return db_rescale_recompute_ref(sig, nv, a2, gmax, nb, num_bins, t_pad,
                                        int_dtype)
    lib = _lib.load_kernels()
    nb_pad = a2.shape[0] // 2
    _check_recompute_operands(sig, a2, gmax, nb, nb_pad, t_pad, int_dtype)
    i0, w0, w1 = _gather_tables(nb, num_bins, sig.device)
    o_start = _bin_block_table(nb, num_bins, nb_pad, sig.device)
    db = torch.empty((nb_pad, t_pad), dtype=torch.float32, device=sig.device)
    out = torch.empty((num_bins, t_pad), dtype=int_dtype, device=sig.device)
    gmax = gmax.reshape(1).contiguous()
    stream = torch.cuda.current_stream(sig.device).cuda_stream
    rc = lib.db_rescale_recompute_tiled_launch(
        sig.data_ptr(), sig.shape[0], a2.data_ptr(), nb_pad, nv,
        gmax.data_ptr(), i0.data_ptr(), w0.data_ptr(), w1.data_ptr(),
        o_start.data_ptr(), t_pad, db.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[int_dtype], LN10_INV_20, DB_FLOOR, INT8_DB_RANGE[0],
        INT8_SCALE, stream)
    _lib.check_launch("db_rescale_recompute_tiled", rc)
    return db, out


def spectrogram(sig: torch.Tensor, valid_len: int, op: StftOperator,
                num_bins: int = 1024, intensity_dtype=torch.float32,
                db_store_dtype=torch.float32, recompute: bool = False,
                psd_precision: str | None = None,
                psd_store_dtype=torch.float32):
    """Full spectrogram export of a packed |slow-time| signal, hop 1.

    sig: [L] float32 magnitude signal (zeros past ``valid_len``).
    Returns (psd [nb, T], db [nb, T], intensity [num_bins, T]) with
    T = L − W + 1 columns; columns ≥ valid_len − W + 1 are zero (psd),
    DB_FLOOR (db) and the floor column through the interpolation
    (intensity).

    psd_precision: phase 1's arithmetic, as the JAX package's
    ``spectrogram_pallas`` takes it: None or "highest" the exact float32
    PSD (K2b up to nb_pad UNTILED_MAX_BINS, then K4a), "high" the bf16x3
    form (K2a). psd_store_dtype: bfloat16 rounds every PSD value to bf16
    before the per-tile max, as JAX's bf16 PSD store does; the psd slot
    then comes back as bf16 (the kernels keep the rounded values in a
    float32 array, which phase 2 reads unchanged). Phase 2 is K3 up to
    nb_pad UNTILED_MAX_BINS, then K4b.

    recompute: True runs a pair that never stores the PSD: the psd slot is
    None, and db and intensity are bit-equal to the materializing exact
    pair's at the same nb_pad (K5a/K5b up to UNTILED_MAX_BINS, then
    psd_tmax_tiled/db_rescale_recompute_tiled).

    As in the JAX package, "high", a bf16 PSD store and a bf16 dB store
    exist on its untiled path only (nb_pad ≤ JAX_UNTILED_MAX_BINS: nfft up
    to 1,022), and neither "high" nor a bf16 store goes with recompute;
    anything else raises ValueError, and so does an unknown precision.
    """
    if op.hop != 1:
        raise ValueError("the fused spectrogram export supports hop=1 only")
    wl = op.window_length
    nb = op.num_bins
    t = sig.shape[0] - wl + 1
    if t <= 0:
        raise ValueError(f"signal shorter than one window ({sig.shape[0]} < {wl})")
    if psd_precision not in (None, "high", "highest"):
        raise ValueError(f"psd_precision must be 'high' or 'highest', "
                         f"got {psd_precision!r}")
    store_bf16 = psd_store_dtype == torch.bfloat16
    db_bf16 = db_store_dtype == torch.bfloat16
    align = 16 if (store_bf16 or db_bf16) else 8
    nb_pad = -(-nb // align) * align
    jax_tiled = nb_pad > JAX_UNTILED_MAX_BINS
    high = psd_precision == "high"
    if (store_bf16 or db_bf16) and (jax_tiled or recompute):
        raise ValueError(
            "psd_store_dtype/db_store_dtype=bfloat16 apply to the untiled "
            f"materializing export only (nb_pad ≤ {JAX_UNTILED_MAX_BINS}, "
            f"without recompute); got nb_pad {nb_pad} at nfft {op.nfft}, "
            f"recompute={recompute}")
    if jax_tiled and recompute:
        raise ValueError(
            f"recompute=True is the untiled formulation (nb_pad ≤ "
            f"{JAX_UNTILED_MAX_BINS}), got nb_pad {nb_pad} at nfft {op.nfft}")
    if high and (jax_tiled or recompute):
        raise ValueError(
            "psd_precision='high' applies to the untiled materializing "
            f"export only (nb_pad ≤ {JAX_UNTILED_MAX_BINS}, without "
            f"recompute); got nb_pad {nb_pad} at nfft {op.nfft}, "
            f"recompute={recompute}")
    t_pad = -(-t // PSD_TILE) * PSD_TILE
    a2 = torch.as_tensor(_folded_operator(op, align=align), device=sig.device)
    nv = valid_len - wl + 1
    untiled = nb_pad <= UNTILED_MAX_BINS
    if recompute:
        if untiled:
            phase1, phase2 = psd_tmax, db_rescale_recompute
        else:
            phase1, phase2 = psd_tmax_tiled, db_rescale_recompute_tiled
        gmax = phase1(sig, nv, a2, nb_pad, t_pad).amax()
        db, intensity = phase2(sig, nv, a2, gmax, nb, num_bins, t_pad,
                               intensity_dtype)
        return None, db[:nb, :t], intensity[:, :t]
    if high:
        phase1 = psd_phase1_b3
    else:
        phase1 = psd_phase1 if untiled else psd_phase1_tiled
    phase2 = db_rescale if untiled else db_rescale_tiled
    p, tmax = phase1(sig, nv, a2, nb_pad, t_pad, round_bf16=store_bf16)
    gmax = tmax.amax()  # stays on the device: no host sync between phases
    db, intensity = phase2(p, gmax, nb, num_bins, db_store_dtype,
                           intensity_dtype)
    psd = p[:nb, :t]
    return (psd.to(torch.bfloat16) if store_bf16 else psd, db[:nb, :t],
            intensity[:, :t])
