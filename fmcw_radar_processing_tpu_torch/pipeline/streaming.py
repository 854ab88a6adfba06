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
processor's device between windows, in buffers updated in place. The left
alignment of each channel's stream and the next carry are index gathers on
the device, so a window whose inputs already lie on the device costs no
host synchronization.

On a CUDA device a window's work is about 90 small operations a channel
and the STFT tail, far more host dispatch than kernel time. So the first
window of each input shape runs eagerly and is then captured into two CUDA
graphs (the per-channel chains with their packing; the STFT tail), and
every later window of that shape copies its inputs into the graphs' static
buffers and replays them: the same kernels in the same order on the same
data. The results are copied out of the graphs' outputs, so a result stays
the caller's after later windows. The CPU runs every window eagerly.

With a ``mesh`` (parallel/mesh.py) the channels shard over its ``data``
axis, as the JAX processor's do: C must divide by the axis size, each rank
processes and keeps the state of its own C/n channels, and its results
stay local; parallel/multihost.py::gather_to_all assembles them. Channels
are independent, so a window needs no communication.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from fmcw_radar_processing_tpu_torch.config import RadarConfig
from fmcw_radar_processing_tpu_torch.dsp.stft import DB_FLOOR, StftOperator, psd_db
from fmcw_radar_processing_tpu_torch.ops import _lib
from fmcw_radar_processing_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import (
    make_frame_chain,
    pack_slow_time,
)
from fmcw_radar_processing_tpu_torch.utils.cplx import pair_abs, resolve_device
from fmcw_radar_processing_tpu_torch.utils.observe import span

DB_MODES = ("per_window", "running_max")
GRAPH_SHAPES = 4  # input shapes a processor keeps captured graphs for


class StreamingWindowResult(NamedTuple):
    """Per-window outputs, leading axis = channel (this rank's channels
    under a mesh), on the processor's device."""

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
    """Stateful multi-channel streaming processor on ``device`` (the card
    unless the caller asks for "cpu").

    window_frames: frames per processing window per channel.
    db_mode: "per_window" or "running_max" (see the module docstring).
    mesh: shards the ``channels`` over its ``data`` axis (ValueError when
    they do not divide by its size); None processes them all here.
    """

    def __init__(self, cfg: RadarConfig, channels: int, window_frames: int,
                 device: torch.device | str = "cuda", nfft: int = 256,
                 db_mode: str = "per_window", mesh: Mesh | None = None):
        if db_mode not in DB_MODES:
            raise ValueError(f"unknown db_mode {db_mode!r}")
        n = mesh.shape[DATA_AXIS] if mesh is not None else 1
        if channels % n:
            raise ValueError(f"{channels} channels not divisible by the data "
                             f"axis ({n})")
        self.cfg = cfg
        self.channels = channels
        self.window_frames = window_frames
        self.mesh = mesh
        self.local_channels = channels // n
        # This rank's channels: [first_channel, first_channel + local_channels).
        self.first_channel = (mesh.index(DATA_AXIS) * self.local_channels
                              if mesh is not None else 0)
        self.device = resolve_device(device)
        self.nfft = nfft
        self.db_mode = db_mode
        a = cfg.algorithm
        self._wl = a.stft_window_length
        self._chain = make_frame_chain(cfg, self.device)
        self._stft = StftOperator.create(
            window_length=self._wl, beta=a.stft_kaiser_beta, nfft=nfft,
            fs=1.0 / cfg.derived.prt, hop=1, precision=a.matmul_precision)
        c, dev = self.local_channels, self.device
        self._carry = torch.zeros((c, self._wl - 1), dtype=torch.float32,
                                  device=dev)
        self._carry_len = torch.zeros((c,), dtype=torch.int32, device=dev)
        self._max_power = torch.zeros((c,), dtype=torch.float32, device=dev)
        self._graphs: dict[tuple, _WindowGraphs] = {}

    def reset(self) -> None:
        """Start every channel's stream anew. The state is zeroed in place:
        the captured graphs read and write these buffers."""
        for t in (self._carry, self._carry_len, self._max_power):
            t.zero_()

    def process_window(self, raw, calib) -> StreamingWindowResult:
        """Process one window.

        raw: [C, F, PN, 2·NTS] flat pair rows or [C, F, PN, NTS, 2];
        calib: [C, NTS, 2]. NumPy arrays or tensors (on any device). Under
        a mesh, either every channel (this rank takes its own) or this
        rank's C/n channels.
        """
        dev = self.device
        c0, nc = self.first_channel, self.local_channels
        with span("stream.upload"):
            if raw.shape[0] == self.channels and nc != self.channels:
                raw, calib = raw[c0:c0 + nc], calib[c0:c0 + nc]
            if raw.ndim == 5:
                raw = raw.reshape(*raw.shape[:3], -1)
            if raw.shape[0] != nc or calib.shape[0] != nc:
                raise ValueError(f"expected {nc} channels, got raw "
                                 f"{tuple(raw.shape)}, calib {tuple(calib.shape)}")
            graphs = self._graphs_for(tuple(raw.shape), tuple(calib.shape))
            if graphs is None:
                raw = torch.as_tensor(raw, dtype=torch.float32, device=dev)
                calib = torch.as_tensor(calib, dtype=torch.float32, device=dev)
                raw = raw.contiguous()
            else:
                graphs.raw.copy_(torch.as_tensor(raw))
                graphs.calib.copy_(torch.as_tensor(calib))
                raw, calib = graphs.raw, graphs.calib
        if graphs is not None and graphs.captured:
            return graphs.replay()
        outs, mags, counts = [], [], []
        for c in range(nc):
            with span("stream.chain"):
                out, mag, count = self._channel(raw[c], calib[c])
                outs.append(out)
                mags.append(mag)
                counts.append(count)
        with span("stream.stft"):
            res = self._stft_tail(outs, mags, counts)
        if graphs is not None:
            graphs.capture(self)
        return res

    def _graphs_for(self, raw_shape, calib_shape) -> _WindowGraphs | None:
        """The graphs of windows of this shape on a CUDA device, made at the
        shape's first window while fewer than GRAPH_SHAPES are kept; None
        (the eager path) otherwise."""
        if self.device.type != "cuda":
            return None
        key = (raw_shape, calib_shape)
        graphs = self._graphs.get(key)
        if graphs is None and len(self._graphs) < GRAPH_SHAPES:
            graphs = self._graphs[key] = _WindowGraphs(raw_shape, calib_shape,
                                                       self.device)
        return graphs

    def _channel(self, raw, calib):
        """One channel's chain, its packed slow-time stream's magnitude
        [F·PN] (valid in [0, count)) and count."""
        out = self._chain(raw, calib)
        sig, count = pack_slow_time(out.strongest_chirps, out.detected,
                                    self.cfg.pn)
        return out, pair_abs(sig), count

    def _stft_tail(self, outs, mags, counts) -> StreamingWindowResult:
        """The window's batched STFT over the channels' packed streams, its
        dB, the carry and max for the next window (into the state, in
        place), and the results."""
        dev, wl = self.device, self._wl
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
        carry = torch.gather(y, 1, idx)
        self._carry.copy_(carry)
        self._carry_len.copy_(torch.clamp_max(total, wl - 1))
        self._max_power.copy_(new_max)
        return StreamingWindowResult(
            waterfall=torch.stack([o.waterfall for o in outs]),
            range=torch.stack([o.range for o in outs]),
            speed=torch.stack([o.speed for o in outs]),
            strength=torch.stack([o.strength for o in outs]),
            detected=torch.stack([o.detected for o in outs]),
            psd=res.power, psd_db=db, norm_power=norm, col_count=n_cols,
            carry=carry,
        )


class _WindowGraphs:
    """One window shape's CUDA graphs: static input buffers, the chain graph
    (every channel's chain, packing and magnitude, whose static outputs the
    tail reads), the tail graph (the processor's ``_stft_tail``), the
    tail's static results, every tensor the graphs read that they did not
    make, and the kernel launches (ops/_lib.py::LAUNCHES) they hold."""

    def __init__(self, raw_shape, calib_shape, device: torch.device):
        self.device = device
        self.raw = torch.empty(raw_shape, dtype=torch.float32, device=device)
        self.calib = torch.empty(calib_shape, dtype=torch.float32,
                                 device=device)
        self.captured = False

    def capture(self, proc: StreamingProcessor) -> None:
        """Capture the window's work from ``proc`` as it is now (its
        ``_chain`` included) on its device. Capture runs nothing, so the
        state does not advance; a capture error is raised."""
        self.chain, self.tail = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        operands = _Operands()
        with torch.cuda.device(self.device), _lib.capture_launches() as n:
            stream = torch.cuda.Stream(self.device)
            with torch.cuda.graph(self.chain, stream=stream), operands:
                self.chains = [proc._channel(self.raw[c], self.calib[c])
                               for c in range(self.raw.shape[0])]
            with torch.cuda.graph(self.tail, stream=stream), operands:
                self.result = proc._stft_tail(*zip(*self.chains))
        self.operands, self.launches = operands.kept, n
        self.captured = True

    def replay(self) -> StreamingWindowResult:
        """One window from the static inputs: both graphs replayed, the
        results copied out of the graphs' outputs."""
        with span("stream.chain"), span("stream.graph_replay"):
            self.chain.replay()
        with span("stream.stft"):
            self.tail.replay()
            res = StreamingWindowResult(*(t.clone() for t in self.result))
        _lib.add_launches(self.launches)
        return res


class _Operands(TorchFunctionMode):
    """While a graph is captured: a reference to every tensor the captured
    work reads that it did not make. A graph holds raw device addresses,
    and a constant that its cache drops (dsp/detection.py::_gate_on is an
    LRU cache) would go back to the allocator while the replays read it.
    A tensor is the capture's own if an operation under it returned its
    storage; the constants' storage stays allocated all through."""

    def __init__(self):
        super().__init__()
        self.made: set[int] = set()
        self.kept: dict[int, torch.Tensor] = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in _tensors((args, kwargs)):
            ptr = t.untyped_storage().data_ptr()
            if ptr not in self.made:
                self.kept.setdefault(ptr, t)
        out = func(*args, **kwargs)
        self.made.update(t.untyped_storage().data_ptr() for t in _tensors(out))
        return out


def _tensors(x):
    """The tensors in ``x``, through tuples, lists and dict values."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


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
