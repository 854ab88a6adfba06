"""Recording pipelines — the reference's ``radar_processing('no')`` and
``radar_processing('yes')``.

Host/device split, as in the JAX package: the per-frame chain, packing and
the spectrogram export run on ``device``; the host reads back the
slow-time valid count once per spectrogram (the STFT's nfft is
2^nextpow2 of it in the reference, radar_processing.m:273, unless the
config pins it) and then assembles the JSON payloads from the final
arrays.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import mmap
import threading
import weakref

import numpy as np
import torch

from fmcw_radar_processing_tpu_torch.config import RadarConfig
from fmcw_radar_processing_tpu_torch.config.radar import next_pow2
from fmcw_radar_processing_tpu_torch.dsp.fast_time import PackedFastTime
from fmcw_radar_processing_tpu_torch.dsp.stft import (
    StftOperator,
    decode_db_int8,
    decode_db_int8_into,
    log_bins_axis,
    log_frequency_rescale,
    psd_db,
    quantize_db_int8,
    resolve_stft_impl,
    stft_frame_count,
)
from fmcw_radar_processing_tpu_torch.ops.stft_cuda import spectrogram
from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import (
    FrameChainOutputs,
    make_frame_chain,
    pack_slow_time,
)
from fmcw_radar_processing_tpu_torch.pipeline.payloads import (
    fft_snapshot_payload,
    range_fft_payload,
    range_speed_payload,
    spectrogram_payload,
)
from fmcw_radar_processing_tpu_torch.utils import observe
from fmcw_radar_processing_tpu_torch.utils.cplx import (
    pair_abs,
    pin_f32_matmul,
    resolve_device,
    to_pair,
)
from fmcw_radar_processing_tpu_torch.utils.observe import NullTimer, span

_STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}

# The raw's page-locked staging ring: slots of this many bytes, this many of
# them. Of 2-32 MB slots, 8 MB uploaded fastest from an H100 machine's host
# with 2 intra-op threads.
_STAGING_SLOT_BYTES = 8 << 20
_STAGING_SLOTS = 2

# The maps' read-back: a device slot of at most this many bytes, each block
# of rows widened into it and copied out to the host in turn; and the free
# page-locked host blocks kept for reuse: one call's two maps and one kept
# result's.
_DECODE_SLOT_BYTES = 256 << 20
_HOST_BLOCKS_KEPT = 4
_HOST_REGISTER_PORTABLE = 1  # cudaHostRegisterPortable


def _normalize_raw(raw: np.ndarray, nts: int) -> np.ndarray:
    """Normalize any accepted raw layout to flat pair rows [F, PN, 2·NTS].

    Accepted: complex [F, PN, NTS], real [F, PN, NTS], pair
    [F, PN, NTS, 2], or already-flat [F, PN, 2·NTS]."""
    raw = np.asarray(raw)
    if np.iscomplexobj(raw):
        raw = to_pair(raw)
    elif raw.ndim == 3 and raw.shape[-1] == nts:
        raw = to_pair(raw)  # real samples: imag = 0
    elif raw.ndim == 3 and raw.shape[-1] != 2 * nts:
        raise ValueError(
            f"ndim-3 raw last dim {raw.shape[-1]} is neither NTS={nts} "
            f"(samples) nor 2·NTS={2 * nts} (flat pair-rows)"
        )
    if raw.ndim == 4 and raw.shape[-1] == 2:
        raw = raw.reshape(*raw.shape[:2], -1)
    return raw


def _decode_blocks(rows: int, cols: int, itemsize: int,
                   slot_bytes: int) -> list[tuple[int, int, int, int]]:
    """The read-back's blocks of a [rows, cols] map: (r0, r1, c0, c1), each
    at most ``slot_bytes`` at ``itemsize`` bytes an element, covering the
    map once and in order. Whole rows, as many as a slot holds; where one
    row alone exceeds a slot, pieces of one row. Either way a block's
    elements are contiguous in the C-ordered host output."""
    if rows == 0 or cols == 0:
        return []
    per = slot_bytes // (cols * itemsize)
    if per:
        return [(r, min(r + per, rows), 0, cols) for r in range(0, rows, per)]
    span = slot_bytes // itemsize
    return [(r, r + 1, c, min(c + span, cols))
            for r in range(rows) for c in range(0, cols, span)]


def _page_locked(nbytes: int) -> np.ndarray | None:
    """``nbytes`` (whole pages) of fresh anonymous host memory, page-locked
    by ``cudaHostRegister``, as a uint8 array that unregisters it when it is
    dropped; None where the mapping or the registration fails (the host's
    memory or locked-memory limit). The pages are populated by the mapping
    itself: registering them then took about half the time of registering
    pages it first had to fault in (34 GB on an H100's host: 11.6 s against
    20.8 s), and about as long as PyTorch's ``cudaHostAlloc``."""
    flags = mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS | mmap.MAP_POPULATE
    try:
        block = np.frombuffer(mmap.mmap(-1, nbytes, flags=flags), np.uint8)
    except OSError:
        return None
    cudart = torch.cuda.cudart()
    ptr = block.ctypes.data
    if cudart.cudaHostRegister(ptr, nbytes, _HOST_REGISTER_PORTABLE) != cudart.cudaError.success:
        _clear_cuda_error()
        return None
    weakref.finalize(block, cudart.cudaHostUnregister, ptr).atexit = False
    return block


def _clear_cuda_error() -> None:
    """Reset the CUDA runtime's last error, which a failed call that
    PyTorch did not check leaves for the next kernel launch's check."""
    major = (torch.version.cuda or "").split(".")[0]
    try:
        ctypes.CDLL(f"libcudart.so.{major}").cudaGetLastError()
    except OSError:
        pass


class _Lease:
    """One host block seen as an array of ``shape`` and ``dtype``: the base
    of the arrays handed out. Its end returns the block to the free list."""

    def __init__(self, block: np.ndarray, shape, dtype: np.dtype):
        self.block_bytes = block.size
        self.__array_interface__ = {"data": (block.ctypes.data, False),
                                    "shape": tuple(shape), "typestr": dtype.str,
                                    "version": 3}


class _HostBlocks:
    """The read-back's page-locked host blocks, of the maps' own sizes
    rounded up to whole pages, kept for reuse. A map takes the smallest
    free block that holds it, else a new one; a block goes back to the
    free list once the last array over it is dropped. At most
    _HOST_BLOCKS_KEPT blocks stay free, the largest: a smaller one beyond
    them is unregistered. So a caller that keeps one result while the next
    is made, at one size or many, needs no new block once the largest two
    calls' worth are free."""

    def __init__(self) -> None:
        self._free: list[np.ndarray] = []
        self._lock = threading.RLock()
        self.registered = 0  # blocks page-locked so far

    @staticmethod
    def block_bytes(nbytes: int) -> int:
        return -(-nbytes // mmap.PAGESIZE) * mmap.PAGESIZE

    def take(self, shape, dtype: np.dtype) -> np.ndarray | None:
        """An array of ``shape`` and ``dtype`` over a page-locked block, or
        None where a new block cannot be page-locked."""
        nbytes = self.block_bytes(math.prod(shape) * dtype.itemsize)
        with self._lock:
            fits = [k for k, b in enumerate(self._free) if b.size >= nbytes]
            if fits:
                block = self._free.pop(min(fits, key=lambda k: self._free[k].size))
            else:
                block = _page_locked(nbytes)
                if block is None:
                    return None
                self.registered += 1
        lease = _Lease(block, shape, dtype)
        weakref.finalize(lease, self._give_back, block).atexit = False
        return np.asarray(lease)

    def _give_back(self, block: np.ndarray) -> None:
        with self._lock:
            self._free.append(block)
            self._free.sort(key=lambda b: b.size)
            del self._free[:-_HOST_BLOCKS_KEPT]  # unregistered as dropped


class _ReadBack:
    """The CUDA maps' way to the host, block by block of rows.

    Each block's rows are trimmed and widened to float32 on the card (int8
    codes decoded to dB, as :func:`decode_db_int8` does on the host) into
    one device slot, then copied by DMA into the same rows of the host
    output; both on the current stream, so a block's widening starts once
    the copy before it is done. The slot is sized to the largest block, at
    most _DECODE_SLOT_BYTES, and kept across calls; the host outputs are
    page-locked blocks of :class:`_HostBlocks`. One wait on the stream,
    after every copy. One read-back at a time."""

    def __init__(self) -> None:
        self.host = _HostBlocks()
        self._slot: torch.Tensor | None = None
        self._lock = threading.Lock()

    def __call__(self, maps: list[torch.Tensor]) -> list[torch.Tensor] | None:
        """The maps as float32 C-contiguous host tensors in page-locked
        memory, or None where a page-locked block cannot be had. Counted:
        the slot's device bytes as "recording.decode_scratch_bytes" and the
        host blocks' page-locked bytes as "recording.decode_host_alloc_bytes"."""
        f32 = np.dtype(np.float32)
        with self._lock:
            arrays = []
            for m in maps:
                arrays.append(self.host.take(m.shape, f32))
                if arrays[-1] is None:
                    return None
            hosts = [torch.from_numpy(a) for a in arrays]
            plan = [(m, h, b) for m, h in zip(maps, hosts)
                    for b in _decode_blocks(*m.shape, f32.itemsize, _DECODE_SLOT_BYTES)]
            need = max([(r1 - r0) * (c1 - c0) * f32.itemsize
                        for _, _, (r0, r1, c0, c1) in plan], default=16)
            if self._slot is None or self._slot.numel() < need:
                self._slot = None  # the old slot goes before the new one comes
                self._slot = torch.empty(-(-need // 512) * 512,  # the allocator's rounding
                                         dtype=torch.uint8, device=maps[0].device)
            observe.count("recording.decode_scratch_bytes", self._slot.numel())
            observe.count("recording.decode_host_alloc_bytes",
                          sum(a.base.block_bytes for a in arrays))
            for m, h, (r0, r1, c0, c1) in plan:
                with span("recording.decode_block"):
                    block = self._slot.view(torch.float32)[: (r1 - r0) * (c1 - c0)]
                    block = block.view(r1 - r0, c1 - c0)
                    if m.dtype == torch.int8:
                        decode_db_int8_into(block, m[r0:r1, c0:c1])
                    else:
                        block.copy_(m[r0:r1, c0:c1])
                    h[r0:r1, c0:c1].copy_(block, non_blocking=True)
            torch.cuda.current_stream(maps[0].device).synchronize()
            return hosts


def _upload_chunks(frames: int, frames_per_slot: int) -> list[tuple[int, int]]:
    """The staging ring's chunks of a recording: [start, stop) of whole
    frames, at most ``frames_per_slot`` each, covering [0, frames) once
    and in order."""
    return [(a, min(a + frames_per_slot, frames))
            for a in range(0, frames, frames_per_slot)]


class _StagingRing:
    """The raw's way to the card through a small ring of page-locked
    float32 slots, chunk by chunk of whole frames: the host fills one slot
    (torch's CPU copy on the intra-op threads, which also casts and gathers
    a strided source) while the copy engine empties the other into the
    destination on the card. A slot's event marks its last copy out; the
    host waits on it before filling the slot again. The slots are taken at
    the first upload and kept: _STAGING_SLOTS × _STAGING_SLOT_BYTES of
    page-locked memory, whatever the recording's length. One upload at a
    time goes through the ring."""

    def __init__(self) -> None:
        self._slots: list[torch.Tensor] | None = None
        self._events: list[torch.cuda.Event] = []
        self._lock = threading.Lock()

    def upload(self, src: torch.Tensor, device: torch.device) -> torch.Tensor | None:
        """``src`` (host memory, any strides and real dtype) as a contiguous
        float32 tensor on ``device``, or None where the page-locked
        allocation raises (the host's locked-memory limit) or a frame
        exceeds a slot. The copies are queued on the device's current
        stream and not waited for: work queued after them reads the
        tensor in order."""
        frame = math.prod(src.shape[1:])
        if frame > _STAGING_SLOT_BYTES // 4:
            return None
        with self._lock:
            if self._slots is None:
                try:
                    self._slots = [torch.empty(_STAGING_SLOT_BYTES // 4,
                                               dtype=torch.float32, pin_memory=True)
                                   for _ in range(_STAGING_SLOTS)]
                except RuntimeError:
                    return None
                self._events = [torch.cuda.Event() for _ in self._slots]
            dest = torch.empty(src.shape, dtype=torch.float32, device=device)
            stream = torch.cuda.current_stream(device)
            per = self._slots[0].numel() // frame
            for k, (a, b) in enumerate(_upload_chunks(src.shape[0], per)):
                i = k % len(self._slots)
                self._events[i].synchronize()  # the slot's last copy out is done
                slot = self._slots[i][: (b - a) * frame].view(b - a, *src.shape[1:])
                slot.copy_(src[a:b])
                dest[a:b].copy_(slot, non_blocking=True)
                self._events[i].record(stream)
            return dest


@dataclasses.dataclass
class RecordingOutputs:
    """Full-recording ('no') mode results (arrays host-side NumPy)."""

    waterfall: np.ndarray  # (K, F)
    target_range: np.ndarray  # (T, F) NaN-filled
    target_speed: np.ndarray  # (T, F)
    target_strength: np.ndarray  # (T, F)
    detected: np.ndarray  # (F,) bool
    spectrogram_times: np.ndarray  # (T_stft,)
    spectrogram_freqs: np.ndarray  # (1024,) log-spaced
    spectrogram_intensity: np.ndarray  # (1024, T_stft) dB
    # Linear-frequency dB PSD — what the reference's PNG renders
    # (surf(T, F, psd) at radar_processing.m:331-340).
    spectrogram_linear_freqs: np.ndarray  # (nb,) uniform one-sided axis
    spectrogram_psd_db: np.ndarray  # (nb, T_stft) dB
    payloads: dict[str, dict]  # name -> payload dict (4 schemas)


@dataclasses.dataclass
class ActivityBatchOutput:
    """One activity-mode ('yes') batch spectrogram (radar_processing.m:444-607)."""

    batch: int  # 1-based batch number
    start_frame: int  # 1-based inclusive
    end_frame: int  # 1-based inclusive
    payload: dict
    filename: str


class RadarPipeline:
    """The recording pipeline for a fixed RadarConfig on one device.

    device: "cuda" by default; "cpu" runs the kernels' plain versions.
    Raises RuntimeError for "cuda" without a card.

    impl: the frame chain's formulation (pipeline/frame_chain.py), any of
    the JAX package's names: "auto" (the profile chain: bf16x3 K1a on the
    card, the exact plain version on the CPU), "pallas_profile" (exact,
    K1b), "pallas_profile_high" (bf16x3, K1a), "pallas_profile_bf16" (one
    bf16 pass, K1c), "pallas" (the materializing chain, K6 + K7), and the
    plain formulations "fused", "fused_bf16" and "xla".

    The export follows ``AlgorithmConfig.stft_impl``
    (dsp/stft.py::resolve_stft_impl): the export kernels for "auto" at hop
    1 and for "pallas", the plain composition otherwise.
    """

    def __init__(self, cfg: RadarConfig, filename: str = "radar_data",
                 device: torch.device | str = "cuda", impl: str = "auto"):
        self.device = resolve_device(device)
        pin_f32_matmul()
        self.cfg = cfg
        self.filename = filename
        self._chain = make_frame_chain(cfg, self.device, impl=impl)
        self._staging = _StagingRing()
        self._read_back = _ReadBack()

    def _device_inputs(self, raw: np.ndarray, calib: np.ndarray):
        """raw as flat pair rows [F, PN, 2·NTS] and calib as a pair
        [NTS, 2], float32 on the pipeline's device.

        On a CUDA device the raw crosses through the pipeline's page-locked
        staging ring (:class:`_StagingRing`), with no host sync at the end;
        through a pageable ``.to`` where the ring refuses it. On the CPU
        the raw tensor shares the caller's float32 memory. Counted: the
        raw's float32 bytes on the device as "recording.upload_bytes" and,
        on a CUDA device, those staged through the ring as
        "recording.upload_staged_bytes"."""
        with span("recording.upload"):
            raw = _normalize_raw(raw, self.cfg.nts)
            calib = np.asarray(calib)
            if np.iscomplexobj(calib) or calib.ndim == 1:
                calib = to_pair(calib)
            raw_t = None
            if self.device.type == "cuda":
                raw_t = self._staging.upload(torch.as_tensor(raw), self.device)
                observe.count("recording.upload_staged_bytes",
                              0 if raw_t is None else raw_t.nbytes)
            if raw_t is None:
                raw_t = torch.as_tensor(raw, dtype=torch.float32).to(self.device)
            observe.count("recording.upload_bytes", raw_t.nbytes)
            return (raw_t,
                    torch.as_tensor(calib, dtype=torch.float32).to(self.device))

    def run_chain(self, raw: np.ndarray, calib: np.ndarray) -> FrameChainOutputs:
        """Run the per-frame chain.

        raw: [F, PN, NTS] complex, pair [F, PN, NTS, 2] float32, or flat
        pair rows [F, PN, 2·NTS]; calib: [NTS] complex or [NTS, 2] pair.
        """
        return self._chain(*self._device_inputs(raw, calib))

    def _spectrogram_of_signal(self, signal: torch.Tensor, count: int,
                               timer=None):
        """STFT export of a packed slow-time signal (first ``count`` samples
        valid): (times, log_bins, intensity, freqs, db) as NumPy arrays
        trimmed to the valid columns, or None if shorter than one window.

        timer stages: "stft" (the device export, synced) and "host_decode":
        the device-to-host copies, span "recording.decode_copy", with the
        bytes that cross counted as "recording.decode_copy_bytes" and, on a
        CUDA device, those landing in page-locked memory as
        "recording.decode_pinned_bytes" (a CUDA map crosses widened to
        float32 by the pipeline's :class:`_ReadBack`, int8 codes decoded,
        block by block of rows, span "recording.decode_block" each, else in
        its store dtype);
        then what host work remains, span "recording.decode_widen": the
        NumPy views, or a pageable copy's int8 decode or widening."""
        tm = timer if timer is not None else NullTimer()
        a = self.cfg.algorithm
        wl = a.stft_window_length
        if count < wl:
            return None
        op = StftOperator.create(
            window_length=wl, beta=a.stft_kaiser_beta,
            nfft=a.stft_nfft or next_pow2(count),  # the nfft bucket (:273)
            fs=1.0 / self.cfg.derived.prt, hop=a.stft_hop or 1,
            precision=a.matmul_precision)
        kernels = resolve_stft_impl(a.stft_impl, op.hop) == "pallas"
        n_valid = stft_frame_count(count, wl, op.hop)
        int_dtype = _STORE_DTYPES[a.intensity_dtype]
        db_store = _STORE_DTYPES[a.stft_db_store]
        psd_store = (torch.bfloat16 if a.stft_psd_store == "bfloat16"
                     else torch.float32)
        psd_precision = a.stft_psd_precision
        if -(-op.num_bins // 8) * 8 > 512:
            # The JAX package's rule (its resolves_tiled): past 512 bins its
            # export is the bin-blocked exact float32 path, whatever the
            # config asks. Which kernels run here is spectrogram()'s own gate.
            db_store = psd_store = torch.float32
            psd_precision = "highest"
        freqs = (np.arange(op.num_bins, dtype=np.float32)
                 * np.float32(op.fs / op.nfft))
        with tm.stage("stft", items=count):
            # Reference: STFT of |slow_time| (radar_processing.m:270).
            sig = pair_abs(signal)
            if kernels:
                _, db, intensity = spectrogram(
                    sig, count, op, a.max_freq_bins, intensity_dtype=int_dtype,
                    db_store_dtype=db_store, psd_precision=psd_precision,
                    psd_store_dtype=psd_store)
            else:
                # The JAX package's XLA branch (stft_impl "xla", and "auto"
                # at hop ≠ 1): the operator product, the float32 dB map
                # (whatever stft_db_store says), the rescale, then the cast.
                db = psd_db(op(sig, valid_len=count).power)
                _, intensity = log_frequency_rescale(
                    freqs, db, a.max_freq_bins, precision=a.rescale_precision,
                    method=a.rescale_method)
                intensity = (quantize_db_int8(intensity) if int_dtype == torch.int8
                             else intensity.to(int_dtype))
            tm.observe((db, intensity))
        with tm.stage("host_decode", items=n_valid):
            with span("recording.decode_copy"):
                maps = [intensity[:, :n_valid], db[:, :n_valid]]
                on_card = intensity.is_cuda
                hosts = self._read_back(maps) if on_card else None
                pinned = hosts is not None
                if not pinned:
                    hosts = [m.cpu() for m in maps]
                intensity, db = hosts
                nbytes = intensity.nbytes + db.nbytes
                observe.count("recording.decode_copy_bytes", nbytes)
                if on_card:
                    observe.count("recording.decode_pinned_bytes",
                                  nbytes if pinned else 0)
            with span("recording.decode_widen"):
                if intensity.dtype == torch.int8:  # a pageable copy's codes
                    intensity_np = decode_db_int8(intensity)
                else:  # float32 already where pinned; else widened here
                    intensity_np = intensity.to(torch.float32).numpy()
                db_np = db.to(torch.float32).numpy()
        # Segment-centre times (t·hop + W/2)/fs, × the float32 reciprocal of
        # fs: what XLA makes of the JAX package's division by a constant.
        times = ((np.arange(n_valid, dtype=np.float32) * np.float32(op.hop)
                  + np.float32(wl / 2.0))
                 * (np.float32(1.0) / np.float32(op.fs)))
        return (times, log_bins_axis(freqs, a.max_freq_bins), intensity_np,
                freqs, db_np)

    def process_recording(self, raw: np.ndarray, calib: np.ndarray,
                          timer=None) -> RecordingOutputs:
        """Full-recording mode — radar_processing('no') (:195-436).

        timer: optional utils.observe.StageTimer — records per-stage,
        device-synced wall times (frame_chain / stft / host_decode /
        payload_build).
        """
        tm = timer if timer is not None else NullTimer()
        cfg = self.cfg
        with tm.stage("frame_chain", items=raw.shape[0]):
            out = self.run_chain(raw, calib)
            signal, count_dev = pack_slow_time(out.strongest_chirps,
                                               out.detected, cfg.pn)
            with span("recording.chain_wait"):
                count = int(count_dev)  # the single host sync of the pipeline

        spec = self._spectrogram_of_signal(signal, count, tm)
        if spec is None:
            times = np.zeros(0)
            log_bins = np.zeros(cfg.algorithm.max_freq_bins)
            intensity = np.zeros((cfg.algorithm.max_freq_bins, 0))
            lin_freqs = np.zeros(0)
            psd = np.zeros((0, 0))
        else:
            times, log_bins, intensity, lin_freqs, psd = spec

        with tm.stage("payload_build"):
            waterfall = out.waterfall.cpu().numpy().T  # (K, F)
            t_range = out.range.cpu().numpy()
            t_speed = out.speed.cpu().numpy()
            t_strength = out.strength.cpu().numpy()
            detected = out.detected.cpu().numpy()
            literal_mag = None
            if cfg.algorithm.compat_linear_index_snapshot:
                literal_mag = self._literal_snapshot_magnitude(raw, calib)
            payloads = {
                "spectrogram_data.json": spectrogram_payload(
                    times, log_bins, intensity
                ),
                f"{self.filename}_range_fft_data.json": range_fft_payload(
                    waterfall, cfg, self.filename
                ),
                f"{self.filename}_range_speed_data.json": range_speed_payload(
                    t_range, t_speed, cfg, self.filename
                ),
                f"{self.filename}_fft_data.json": fft_snapshot_payload(
                    waterfall, cfg, self.filename,
                    literal_chirp_magnitude=literal_mag,
                ),
            }
        return RecordingOutputs(
            waterfall=waterfall,
            target_range=t_range,
            target_speed=t_speed,
            target_strength=t_strength,
            detected=detected,
            spectrogram_times=times,
            spectrogram_freqs=log_bins,
            spectrogram_intensity=intensity,
            spectrogram_linear_freqs=lin_freqs,
            spectrogram_psd_db=psd,
            payloads=payloads,
        )

    def _literal_snapshot_magnitude(self, raw: np.ndarray, calib: np.ndarray,
                                    chirp_1based: int = 100) -> np.ndarray:
        """Quirk #2 literal value (compat_linear_index_snapshot): |range
        FFT| of chirp #``chirp_1based`` overall — what MATLAB column-linear
        indexing of the (K, PN, F) cube returns for
        ``range_tx1rx1_complete(:, 100)`` (radar_processing.m:410-411).
        Recomputed for the one owning frame (the cube itself is never
        materialized)."""
        cfg = self.cfg
        raw = _normalize_raw(raw, cfg.nts)
        lin = min(chirp_1based - 1, raw.shape[0] * cfg.pn - 1)  # 0-based, clamped
        fr, ch = lin // cfg.pn, lin % cfg.pn
        raw_t, calib_t = self._device_inputs(raw[fr : fr + 1], calib)
        rf = PackedFastTime.create(cfg, self.device).rf(raw_t, calib_t)
        return pair_abs(rf[0, ch]).cpu().numpy()  # [K]

    def process_activity(self, raw: np.ndarray,
                         calib: np.ndarray) -> list[ActivityBatchOutput]:
        """Animal-activity batch mode — radar_processing('yes') (:440-607).

        Frames are processed in batches of ``batch_size`` (100); each batch
        with ≥ window_length slow-time samples yields one spectrogram JSON,
        capped at ``max_plots`` (4). The per-frame chain runs ONCE over the
        whole recording — only packing and the STFT are per batch.
        """
        cfg = self.cfg
        a = cfg.algorithm
        out = self.run_chain(raw, calib)
        f = raw.shape[0]
        results: list[ActivityBatchOutput] = []
        for b in range(-(-f // a.batch_size)):
            if len(results) >= a.max_plots:
                break  # :597-599
            start = b * a.batch_size
            end = min((b + 1) * a.batch_size, f)
            signal, count_dev = pack_slow_time(out.strongest_chirps[start:end],
                                               out.detected[start:end], cfg.pn)
            spec = self._spectrogram_of_signal(signal, int(count_dev))
            if spec is None:
                continue  # :534,601-606 insufficient data — no JSON
            times, log_bins, intensity = spec[:3]
            results.append(ActivityBatchOutput(
                batch=b + 1,
                start_frame=start + 1,
                end_frame=end,
                payload=spectrogram_payload(
                    times, log_bins, intensity, batch=b + 1,
                    start_frame=start + 1, end_frame=end,
                    filename_base=self.filename),
                filename=f"{self.filename}_spectrogram_batch_{b + 1}.json",
            ))
        return results
