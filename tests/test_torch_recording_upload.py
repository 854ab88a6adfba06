"""PyTorch port: the recording's raw upload (pipeline/recording.py::
_device_inputs and its page-locked staging ring, _StagingRing).

On a CUDA device the raw crosses to the card chunk by chunk of whole
frames through a fixed ring of page-locked float32 slots; the device
tensor is ``.to(device)``'s of the float32 raw, bit for bit, and so is
every output of a recording. On the CPU the raw tensor shares the
caller's memory. The chunk plan, the CPU path and the ring's loop (with
fake events and pageable slots) are checked here on the CPU; the tests
marked ``cuda`` check the ring on the card.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fmcw_radar_processing_tpu_torch.config import (
    AlgorithmConfig,
    RadarConfig,
    default_device_config,
)
from fmcw_radar_processing_tpu_torch.io.synth import SyntheticTarget, synthesize_recording
from fmcw_radar_processing_tpu_torch.pipeline import recording
from fmcw_radar_processing_tpu_torch.pipeline.recording import (
    RadarPipeline,
    _normalize_raw,
    _StagingRing,
    _upload_chunks,
)
from fmcw_radar_processing_tpu_torch.utils import observe
from fmcw_radar_processing_tpu_torch.utils.observe import PROFILED

TARGETS = (SyntheticTarget(range_m=7.5, doppler_bin_offset=3),
           SyntheticTarget(range_m=16.9, doppler_bin_offset=-2))
PROFILES = ("production", "fidelity", "int8")
CFG = RadarConfig.create(default_device_config(), AlgorithmConfig.production())
FRAME = (CFG.pn, 2 * CFG.nts)  # one frame of flat pair rows
PER_SLOT = recording._STAGING_SLOT_BYTES // (4 * CFG.pn * 2 * CFG.nts)


def _algo(name: str) -> AlgorithmConfig:
    production = AlgorithmConfig.production()
    return {"fidelity": AlgorithmConfig(), "production": production,
            "int8": dataclasses.replace(production, intensity_dtype="int8")}[name]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def profiled(monkeypatch):
    """The collector emptied, as a new process finds it, for one profile."""
    PROFILED.records.clear()
    monkeypatch.setattr(observe, "_unprofiled_span_since", True)
    yield lambda: profile(activities=[ProfilerActivity.CPU])
    PROFILED.records.clear()


def _no_pinning(monkeypatch):
    """torch.empty raises where asked for page-locked memory."""
    real_empty = torch.empty

    def no_pinning(*args, pin_memory=False, **kwargs):
        if pin_memory:
            raise RuntimeError("CUDA error: out of memory")
        return real_empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", no_pinning)


def _source(kind: str, frames: int, seed: int = 0):
    """A raw of ``frames`` frames as a caller may pass it: float32 flat pair
    rows, complex samples, or a strided float32 view (every other frame)."""
    rng = np.random.default_rng(seed + frames)
    if kind == "complex":
        re, im = rng.standard_normal((2, frames, CFG.pn, CFG.nts), dtype=np.float32)
        return (re + 1j * im).astype(np.complex64)
    rows = rng.standard_normal((2 * frames if kind == "strided" else frames, *FRAME),
                               dtype=np.float32)
    return rows[::2] if kind == "strided" else rows


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got.cpu().view(torch.int32), want.cpu().view(torch.int32))


# --- the CPU ----------------------------------------------------------------------


@pytest.mark.parametrize("frames,per", [(5, 8), (16, 8), (19, 8), (1, 8), (1, 1),
                                        (65536, 1024)])
def test_chunk_plan_covers_every_frame_once_in_order(frames, per):
    """Below one slot, a multiple of it, a remainder, one frame, and the
    production recording at 8 MB slots."""
    chunks = _upload_chunks(frames, per)
    assert [f for a, b in chunks for f in range(a, b)] == list(range(frames))
    assert all(0 < b - a <= per for a, b in chunks)
    assert len(chunks) == -(-frames // per)


def test_cpu_upload_shares_the_callers_memory(profiled):
    """On the CPU the raw tensor is a view of the caller's float32 pair
    rows (no copy); the raw's bytes are counted, no staged bytes."""
    raw = _source("pairs", 6)
    calib = np.ones((CFG.nts, 2), np.float32)
    pipe = RadarPipeline(CFG, device="cpu")
    with profiled():
        raw_t, calib_t = pipe._device_inputs(raw, calib)
    assert raw_t.data_ptr() == raw.ctypes.data and np.shares_memory(raw_t.numpy(), raw)
    assert calib_t.shape == (CFG.nts, 2)
    assert PROFILED.records["recording.upload_bytes"].items == raw.nbytes
    assert "recording.upload_staged_bytes" not in PROFILED.records


class _FakeEvent:
    """A CUDA event's stand-in that logs its slot's waits and records."""

    def __init__(self, log, slot):
        self.log, self.slot = log, slot
        self.log.append(("made", slot))

    def synchronize(self):
        self.log.append(("wait", self.slot))

    def record(self, stream):
        self.log.append(("record", self.slot))


@pytest.fixture
def fake_ring(monkeypatch):
    """The ring on the CPU: pageable slots of 3 frames, fake events, and
    the log of their waits and records."""
    log: list = []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, pin_memory=False, **k: real_empty(*a, **k))
    slots = itertools.count()
    monkeypatch.setattr(torch.cuda, "Event", lambda: _FakeEvent(log, next(slots)))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(recording, "_STAGING_SLOT_BYTES", 3 * 4 * FRAME[0] * FRAME[1])
    return _StagingRing(), log


@pytest.mark.parametrize("kind", ["pairs", "complex", "strided", "float64"])
@pytest.mark.parametrize("frames", [1, 3, 4, 9])
def test_ring_loop_on_the_cpu(fake_ring, kind, frames):
    """Each chunk waits on its slot's event before the slot is filled and
    records it after the copy out, slots in turn; the result is the
    float32 raw's, bit for bit, over two uploads through one ring."""
    ring, log = fake_ring
    for seed in (0, 1):
        src = _source("pairs" if kind == "float64" else kind, frames, seed)
        if kind == "float64":
            src = src.astype(np.float64)
        rows = torch.as_tensor(_normalize_raw(src, CFG.nts))
        got = ring.upload(rows, torch.device("cpu"))
        _same_bits(got, rows.to(torch.float32))
        assert got.is_contiguous()
    slots = [("made", 0), ("made", 1)]
    turns = [e for k in range(-(-frames // 3)) for e in (("wait", k % 2), ("record", k % 2))]
    assert log == slots + turns + turns


def test_ring_refuses_a_frame_larger_than_a_slot(fake_ring):
    ring, log = fake_ring
    assert ring.upload(torch.zeros(2, 4 * FRAME[0], FRAME[1]), torch.device("cpu")) is None
    assert log == []


def test_ring_refuses_where_pinning_raises(monkeypatch):
    _no_pinning(monkeypatch)
    assert _StagingRing().upload(torch.zeros(2, *FRAME), torch.device("cpu")) is None


# --- on the card --------------------------------------------------------------------


def _pageable(raw, card):
    """The raw as the pageable upload sends it: the float32 normalized raw,
    ``.to`` the card."""
    return torch.as_tensor(_normalize_raw(raw, CFG.nts), dtype=torch.float32).to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pairs", "complex", "strided"])
@pytest.mark.parametrize("frames", [1, PER_SLOT, PER_SLOT + 1, 3 * PER_SLOT])
def test_staged_upload_bit_identical_to_pageable(card, kind, frames):
    """At one frame, a slot, a slot and one, three slots: the device tensor
    equals ``.to(device)``'s, contiguous float32 on the card."""
    raw = _source(kind, frames)
    calib = np.ones(CFG.nts, np.complex64)
    pipe = RadarPipeline(CFG, device=card)
    raw_t, calib_t = pipe._device_inputs(raw, calib)
    assert raw_t.is_cuda and raw_t.is_contiguous() and calib_t.is_cuda
    _same_bits(raw_t, _pageable(raw, card))


@pytest.mark.cuda
def test_back_to_back_uploads_keep_the_first(card):
    """A second upload through the ring, queued before the first is waited
    for, leaves the first's device tensor equal to its source: each slot is
    refilled only after its copy out. The stream is held busy first, so
    that every copy out lags the host's refills unless the host waits."""
    pipe = RadarPipeline(CFG, device=card)
    calib = np.ones(CFG.nts, np.complex64)
    a, b = _source("pairs", 3 * PER_SLOT, 1), _source("pairs", 3 * PER_SLOT, 2)
    pipe._device_inputs(a[:1], calib)  # the slots taken
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # about 0.1 s of the stream
    first, _ = pipe._device_inputs(a, calib)
    second, _ = pipe._device_inputs(b, calib)
    torch.cuda.synchronize()
    _same_bits(first, torch.as_tensor(a))
    _same_bits(second, torch.as_tensor(b))


@pytest.mark.cuda
def test_pageable_fallback_where_pinning_raises(card, monkeypatch, profiled):
    """Where the page-locked allocation raises, the raw goes up by the
    pageable ``.to``: the same values, no bytes counted as staged."""
    raw = _source("pairs", PER_SLOT + 1)
    want = _pageable(raw, card)
    _no_pinning(monkeypatch)
    pipe = RadarPipeline(CFG, device=card)
    with profiled():
        raw_t, _ = pipe._device_inputs(raw, np.ones(CFG.nts, np.complex64))
    _same_bits(raw_t, want)
    assert PROFILED.records["recording.upload_staged_bytes"].items == 0
    assert PROFILED.records["recording.upload_bytes"].items == raw.nbytes


@pytest.mark.cuda
def test_staged_bytes_are_the_uploaded_bytes(card, profiled):
    """On the card every byte of the raw goes through the ring, at two
    uploads: recording.upload_staged_bytes equals recording.upload_bytes."""
    pipe = RadarPipeline(CFG, device=card)
    raws = [_source("complex", 2 * PER_SLOT + 5), _source("pairs", 7)]
    with profiled():
        for raw in raws:
            pipe._device_inputs(raw, np.ones(CFG.nts, np.complex64))
    want = sum(r.size * (8 if np.iscomplexobj(r) else 4) for r in raws)
    assert PROFILED.records["recording.upload_bytes"].items == want
    assert PROFILED.records["recording.upload_staged_bytes"].items == want


def _assert_same(a, b, where="out"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(a.view(f"u{a.itemsize}"),
                                          b.view(f"u{b.itemsize}"), err_msg=where)
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), where
    else:
        assert a == b, where


@pytest.mark.cuda
@pytest.mark.parametrize("name", PROFILES)
def test_recording_identical_to_pageable_upload(name, card, monkeypatch):
    """process_recording through the ring (slots of 100 frames here: 11
    chunks of 1,024 frames) gives every output, payloads included, bit for
    bit as a pipeline whose ring refuses every upload."""
    monkeypatch.setattr(recording, "_STAGING_SLOT_BYTES", 100 * 4 * FRAME[0] * FRAME[1])
    cfg = RadarConfig.create(default_device_config(), _algo(name))
    rec = synthesize_recording(cfg, 1024, TARGETS, seed=1024)
    raw, calib = rec.frames[:, 0], rec.calib_vector(0, cfg.nts)
    staged = RadarPipeline(cfg, device=card)
    pageable = RadarPipeline(cfg, device=card)
    monkeypatch.setattr(pageable._staging, "upload", lambda src, device: None)
    got = staged.process_recording(raw, calib)
    want = pageable.process_recording(raw, calib)
    assert got.spectrogram_intensity.shape[1] > 0
    _assert_same(dataclasses.asdict(got), dataclasses.asdict(want))
