"""K2/K3, K4a/K4b and K5a/K5b: the fused spectrogram export (STFT → PSD →
dB → log bins).

:func:`spectrogram` is the port of the JAX package's
``ops/stft_pallas.py::spectrogram_pallas``, hop 1. It runs one of two
kernel pairs, by the padded bin count nb_pad, or with ``recompute=True``
the recompute pair:

  nb_pad ≤ 272 (nfft ≤ 512), the untiled pair, which keeps the operator or
  a dB tile whole in shared memory:
    K2 :func:`psd_phase1` — one-sided PSD [nb_pad, t_pad] of every sliding
       20-sample window, columns past the valid count zeroed, plus the max
       of the stored values per 1024-column block (replaces
       ``_psd_kernel_b3`` and ``_psd_kernel``);
    K3 :func:`db_rescale` — dB map in the store dtype and the
       [1024, t_pad] log-frequency intensity in float32, bfloat16 or int8
       (replaces ``_db_rescale_kernel``);
  any larger nb_pad, the bin-blocked pair (128-bin blocks):
    K4a :func:`psd_phase1_tiled` — the same PSD, with one max per column
       tile and bin block (replaces ``_psd_kernel_tiled``);
    K4b :func:`db_rescale_tiled` — the same dB map and intensity, walking
       the bin blocks in order (replaces ``_db_rescale_kernel_tiled``);
  recompute=True, nb_pad ≤ 272, float32 dB map — the PSD is never stored:
    K5a :func:`psd_tmax` — K2's per-block maxima only (replaces
       ``_tmax_kernel``);
    K5b :func:`db_rescale_recompute` — K2's PSD recomputed per column tile,
       then K3's dB map and intensity, bit-equal to K2 → K3's (replaces
       ``_db_rescale_recompute_kernel``).

Between the phases a ``torch.amax`` of the maxima — the one cross-column
dependency of the global-max dB normalization — stays on the device.

Each wrapper runs its plain PyTorch version for CPU tensors and launches
its kernel (``csrc/stft_export.cu``, ``csrc/stft_export_tiled.cu``), or
raises, for CUDA tensors. All six kernels compute at exact float32, which
meets both of the JAX package's phase-1 precision classes ("high" and
"highest"); the plain versions :func:`psd_phase1_ref` and
:func:`db_rescale_ref` compute both pairs' functions at any nb, and
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
DB_TILE = 128  # columns per K3 block
DB_TILED_TILE = 32  # columns per K4b block
BIN_BLOCK = 128  # bins per K4a/K4b bin block
WINDOW = 20  # the window length the kernels are built for
# nb_pad ceiling of the untiled kernels: nfft 512 under the bf16 store's
# 16-alignment. K3 keeps an nb_pad × 128 float32 dB tile in shared memory
# (139 KB here; 227 KB is the most a block may have). Past it,
# :func:`spectrogram` takes the bin-blocked pair K4a/K4b.
UNTILED_MAX_BINS = 272
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


def psd_phase1_ref(sig: torch.Tensor, nv: int, a2: torch.Tensor, nb_pad: int,
                   t_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2 and K4a (im2col by ``unfold`` + one float32
    matmul), at any nb_pad.

    sig: [L] float32 with L − W + 1 ≤ t_pad; nv: valid column count.
    Returns (p [nb_pad, t_pad], tmax [t_pad / PSD_TILE]); K4a's tmax is cut
    finer (per bin block too) but has the same max."""
    pin_f32_matmul()
    wl = a2.shape[1]
    sig_pad = F.pad(sig.to(torch.float32), (0, t_pad + wl - 1 - sig.shape[0]))
    frames = sig_pad.unfold(0, wl, 1).T  # [W, t_pad]
    s2 = a2 @ frames
    p = s2[:nb_pad] ** 2 + s2[nb_pad:] ** 2
    col = torch.arange(t_pad, device=sig.device)
    p = torch.where(col < nv, p, 0.0)
    tmax = p.reshape(nb_pad, t_pad // PSD_TILE, PSD_TILE).amax(dim=(0, 2))
    return p, tmax


def _check_untiled(nb_pad: int) -> None:
    if nb_pad > UNTILED_MAX_BINS:
        raise ValueError(
            f"the untiled export kernels take nb_pad ≤ {UNTILED_MAX_BINS}, "
            f"got {nb_pad}: use psd_phase1_tiled and db_rescale_tiled")


def _check_phase1_operands(sig: torch.Tensor, a2: torch.Tensor, nb_pad: int,
                           t_pad: int) -> None:
    """What K2 and K4a both take."""
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


def psd_phase1(sig: torch.Tensor, nv: int, a2: torch.Tensor, nb_pad: int,
               t_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K2. CPU tensors: the plain version; CUDA tensors: the kernel."""
    if sig.device.type == "cpu":
        return psd_phase1_ref(sig, nv, a2, nb_pad, t_pad)
    lib = _lib.load_kernels()
    _check_untiled(nb_pad)
    _check_phase1_operands(sig, a2, nb_pad, t_pad)
    p = torch.empty((nb_pad, t_pad), dtype=torch.float32, device=sig.device)
    tmax = torch.empty(t_pad // PSD_TILE, dtype=torch.float32,
                       device=sig.device)
    stream = torch.cuda.current_stream(sig.device).cuda_stream
    rc = lib.psd_phase1_launch(sig.data_ptr(), sig.shape[0], a2.data_ptr(),
                               nb_pad, p.data_ptr(), tmax.data_ptr(), t_pad,
                               nv, stream)
    _lib.check_launch("psd_phase1", rc)
    return p, tmax


def psd_phase1_tiled(sig: torch.Tensor, nv: int, a2: torch.Tensor,
                     nb_pad: int, t_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K4a, any nb_pad. CPU tensors: the plain version; CUDA tensors: the
    kernel. Returns (p [nb_pad, t_pad], tmax [ceil(nb_pad / BIN_BLOCK) ·
    t_pad / PSD_TILE])."""
    if sig.device.type == "cpu":
        return psd_phase1_ref(sig, nv, a2, nb_pad, t_pad)
    lib = _lib.load_kernels()
    _check_phase1_operands(sig, a2, nb_pad, t_pad)
    p = torch.empty((nb_pad, t_pad), dtype=torch.float32, device=sig.device)
    tmax = torch.empty(-(-nb_pad // BIN_BLOCK) * (t_pad // PSD_TILE),
                       dtype=torch.float32, device=sig.device)
    stream = torch.cuda.current_stream(sig.device).cuda_stream
    rc = lib.psd_phase1_tiled_launch(sig.data_ptr(), sig.shape[0],
                                     a2.data_ptr(), nb_pad, p.data_ptr(),
                                     tmax.data_ptr(), t_pad, nv, stream)
    _lib.check_launch("psd_phase1_tiled", rc)
    return p, tmax


def psd_tmax_ref(sig: torch.Tensor, nv: int, a2: torch.Tensor, nb_pad: int,
                 t_pad: int) -> torch.Tensor:
    """Plain version of K5a: the tmax [t_pad / PSD_TILE] of
    :func:`psd_phase1_ref`."""
    return psd_phase1_ref(sig, nv, a2, nb_pad, t_pad)[1]


def psd_tmax(sig: torch.Tensor, nv: int, a2: torch.Tensor, nb_pad: int,
             t_pad: int) -> torch.Tensor:
    """K5a: K2's per-block PSD maxima without the PSD. CPU tensors: the
    plain version; CUDA tensors: the kernel."""
    if sig.device.type == "cpu":
        return psd_tmax_ref(sig, nv, a2, nb_pad, t_pad)
    lib = _lib.load_kernels()
    _check_untiled(nb_pad)
    _check_phase1_operands(sig, a2, nb_pad, t_pad)
    tmax = torch.empty(t_pad // PSD_TILE, dtype=torch.float32,
                       device=sig.device)
    stream = torch.cuda.current_stream(sig.device).cuda_stream
    rc = lib.psd_tmax_launch(sig.data_ptr(), sig.shape[0], a2.data_ptr(),
                             nb_pad, tmax.data_ptr(), t_pad, nv, stream)
    _lib.check_launch("psd_tmax", rc)
    return tmax


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
    """K5b. CPU tensors: the plain version; CUDA tensors: the kernel.

    sig, nv, a2, t_pad as :func:`psd_phase1`; gmax: one float32 on sig's
    device. Returns (db [nb_pad, t_pad] float32, intensity [num_bins,
    t_pad] int_dtype)."""
    if sig.device.type == "cpu":
        return db_rescale_recompute_ref(sig, nv, a2, gmax, nb, num_bins, t_pad,
                                        int_dtype)
    lib = _lib.load_kernels()
    nb_pad = a2.shape[0] // 2
    _check_untiled(nb_pad)
    _check_phase1_operands(sig, a2, nb_pad, t_pad)
    _check_gmax(gmax, sig.device)
    if not 2 <= nb <= nb_pad or int_dtype not in _DTYPE_CODE:
        raise ValueError(f"K5b takes 2 ≤ nb ≤ nb_pad and intensity in "
                         f"{list(_DTYPE_CODE)}; got nb {nb}, nb_pad {nb_pad}, "
                         f"{int_dtype}")
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


def spectrogram(sig: torch.Tensor, valid_len: int, op: StftOperator,
                num_bins: int = 1024, intensity_dtype=torch.float32,
                db_store_dtype=torch.float32, recompute: bool = False):
    """Full spectrogram export of a packed |slow-time| signal, hop 1.

    sig: [L] float32 magnitude signal (zeros past ``valid_len``).
    Returns (psd [nb, T], db [nb, T], intensity [num_bins, T]) with
    T = L − W + 1 columns; columns ≥ valid_len − W + 1 are zero (psd),
    DB_FLOOR (db) and the floor column through the interpolation
    (intensity). nb_pad ≤ UNTILED_MAX_BINS runs K2/K3, larger K4a/K4b.

    recompute: True runs K5a/K5b, which never store the PSD: the psd slot
    is None, and db and intensity are bit-equal to K2/K3's. As in the JAX
    package it takes a float32 dB map only, and nb_pad ≤ UNTILED_MAX_BINS
    (the port's untiled domain: every power-of-two nfft up to 512);
    anything else raises ValueError.
    """
    if op.hop != 1:
        raise ValueError("the fused spectrogram export supports hop=1 only")
    wl = op.window_length
    nb = op.num_bins
    t = sig.shape[0] - wl + 1
    if t <= 0:
        raise ValueError(f"signal shorter than one window ({sig.shape[0]} < {wl})")
    align = 16 if db_store_dtype == torch.bfloat16 else 8
    nb_pad = -(-nb // align) * align
    t_pad = -(-t // PSD_TILE) * PSD_TILE
    a2 = torch.as_tensor(_folded_operator(op, align=align), device=sig.device)
    nv = valid_len - wl + 1
    if recompute:
        if db_store_dtype == torch.bfloat16:
            raise ValueError("recompute=True stores the dB map in float32 "
                             "only (it never stores the PSD either)")
        if nb_pad > UNTILED_MAX_BINS:
            raise ValueError(
                f"recompute=True is the untiled formulation (nb_pad ≤ "
                f"{UNTILED_MAX_BINS}), got nb_pad {nb_pad} at nfft {op.nfft}")
        gmax = psd_tmax(sig, nv, a2, nb_pad, t_pad).amax()
        db, intensity = db_rescale_recompute(sig, nv, a2, gmax, nb, num_bins,
                                             t_pad, intensity_dtype)
        return None, db[:nb, :t], intensity[:, :t]
    if nb_pad <= UNTILED_MAX_BINS:
        phase1, phase2 = psd_phase1, db_rescale
    else:
        phase1, phase2 = psd_phase1_tiled, db_rescale_tiled
    p, tmax = phase1(sig, nv, a2, nb_pad, t_pad)
    gmax = tmax.amax()  # stays on the device: no host sync between phases
    db, intensity = phase2(p, gmax, nb, num_bins, db_store_dtype,
                           intensity_dtype)
    return p[:nb, :t], db[:nb, :t], intensity[:, :t]
