"""PyTorch port: the recording's maps read back on the card
(pipeline/recording.py::_ReadBack).

On a CUDA device each trimmed map goes to the host block by block of rows:
the rows widened to float32 on the card (int8 codes decoded to dB) into
one device slot, then copied by DMA into the same rows of a page-locked
host block that holds the map, of its own size rounded up to whole pages
where none is free, which the pipeline keeps for reuse (_HostBlocks); the
returned arrays are NumPy views of those blocks. The values are the
pageable read-back's, bit for bit: ``.cpu()`` of the trimmed store, then
widened (or int8-decoded) on the host. The block plan, the read-back's
loop (a fake stream, pageable blocks) and the blocks' reuse are checked
here on the CPU; the
tests marked ``cuda`` need a card, and the one also marked ``slow`` runs
K2a, K3 and the read-back on a packed signal of 2^23 samples, 2^33
intensity elements. The CPU path is held unchanged by
``tests/test_torch_observe.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import tracemalloc
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fmcw_radar_processing_tpu_torch.config import (
    AlgorithmConfig,
    RadarConfig,
    default_device_config,
)
from fmcw_radar_processing_tpu_torch.dsp.stft import DB_FLOOR, StftOperator, decode_db_int8
from fmcw_radar_processing_tpu_torch.ops import stft_cuda as stc
from fmcw_radar_processing_tpu_torch.io.synth import SyntheticTarget, synthesize_recording
from fmcw_radar_processing_tpu_torch.pipeline import recording
from fmcw_radar_processing_tpu_torch.pipeline.recording import (
    RadarPipeline,
    _decode_blocks,
    _HostBlocks,
    _ReadBack,
)
from fmcw_radar_processing_tpu_torch.utils import observe
from fmcw_radar_processing_tpu_torch.utils.observe import PROFILED

FRAMES = 1024
TARGETS = (SyntheticTarget(range_m=7.5, doppler_bin_offset=3),
           SyntheticTarget(range_m=16.9, doppler_bin_offset=-2))
PROFILES = ("production", "fidelity", "int8")
SLOT = recording._DECODE_SLOT_BYTES
PAGE = _HostBlocks.block_bytes(1)
# Trimmed maps (rows, valid columns) of the benchmark's recordings: 10% of
# frames muted, 16 chirps a frame, a 20-sample window.
DAY_COLS = 576_000 * 9 // 10 * 16 - 19  # production-576k: 8,294,381
PROD_COLS = (65_536 - 6_554) * 16 - 19  # production-65k: 943,693


def _algo(name: str) -> AlgorithmConfig:
    production = AlgorithmConfig.production()
    return {"fidelity": AlgorithmConfig(), "production": production,
            "int8": dataclasses.replace(production, intensity_dtype="int8")}[name]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pipeline(name, card, seeds=(FRAMES,)):
    """The pipeline of profile ``name`` on the card and one recording
    (raw, calib) a seed."""
    cfg = RadarConfig.create(default_device_config(), _algo(name))
    recs = [synthesize_recording(cfg, FRAMES, TARGETS, seed=s) for s in seeds]
    return (RadarPipeline(cfg, device=card),
            [(r.frames[:, 0], r.calib_vector(0, cfg.nts)) for r in recs])


def _same_bits(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def _pageable_spy(monkeypatch):
    """Wrap the pipelines' read-back so that each call first records the
    pageable read-back of its maps: ``.cpu()`` of the trimmed store."""
    seen = []
    real = _ReadBack.__call__

    def spy(self, maps):
        seen.append([m.cpu() for m in maps])
        return real(self, maps)

    monkeypatch.setattr(_ReadBack, "__call__", spy)
    return seen


# --- the CPU ----------------------------------------------------------------------


@pytest.mark.parametrize("rows,cols,itemsize,slot", [
    (1024, DAY_COLS, 4, SLOT),  # production-576k's intensity: 7 rows a block
    (129, DAY_COLS, 4, SLOT),  # its dB map
    (1024, DAY_COLS, 1, SLOT),  # the int8 intensity
    (1024, PROD_COLS, 4, SLOT),  # production-65k's intensity: 67 rows a block
    (1024, 14_731, 4, SLOT),  # fidelity-1k's: one block
    (7, 50, 4, 3 * 50 * 4),  # whole slots, then a remainder
    (3, 100, 4, 64),  # a row wider than a slot: pieces of one row
    (2, 17, 1, 5),  # pieces with a remainder
    (0, 9, 4, 64), (4, 0, 4, 64),  # nothing to copy
])
def test_decode_block_plan_covers_each_map_once_in_order(rows, cols, itemsize, slot):
    """The blocks cover the map's elements once, in C order, each within a
    slot; whole rows wherever one row fits a slot, as many as fit. A day's
    maps are planned from their shapes alone: nothing of their size is
    allocated."""
    tracemalloc.start()
    try:
        blocks = _decode_blocks(rows, cols, itemsize, slot)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 1 << 20
    pos = 0
    for r0, r1, c0, c1 in blocks:
        assert 0 < (r1 - r0) * (c1 - c0) * itemsize <= slot
        assert r0 * cols + c0 == pos  # contiguous in the host output, in order
        assert (c0, c1) == (0, cols) or r1 == r0 + 1
        pos = (r1 - 1) * cols + c1
    assert pos == rows * cols
    per = slot // max(cols * itemsize, 1)
    if per and rows and cols:
        assert len(blocks) == -(-rows // per)


class _FakeStream:
    """A CUDA stream's stand-in that logs its waits."""

    def __init__(self, log, name):
        self.log, self.name = log, name

    def synchronize(self):
        self.log.append(("sync", self.name))


@pytest.fixture
def fake_read_back(monkeypatch):
    """The read-back on the CPU: pageable host blocks, a fake current
    stream, and the log of its waits."""
    log: list = []
    current = _FakeStream(log, "current")
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: current)
    monkeypatch.setattr(recording, "_page_locked", lambda n: np.empty(n, np.uint8))
    return log


def _cpu_maps(seed, rows=7, cols=60, valid=52, codes=False):
    """A bf16 intensity (int8 codes with ``codes``) and a float32 dB map,
    trimmed to ``valid`` columns."""
    g = torch.Generator().manual_seed(seed)
    intensity = (torch.randint(-128, 128, (rows, cols), generator=g, dtype=torch.int8)
                 if codes else torch.randn(rows, cols, generator=g).to(torch.bfloat16))
    return [intensity[:, :valid], torch.randn(3, cols, generator=g)[:, :valid]]


def _widened(m: torch.Tensor) -> torch.Tensor:
    """A map as the pageable read-back widens it on the host."""
    return (torch.from_numpy(decode_db_int8(m)) if m.dtype == torch.int8
            else m.float())


@pytest.mark.parametrize("codes", [False, True], ids=["bf16", "int8"])
def test_read_back_loop_on_the_cpu(fake_read_back, monkeypatch, codes):
    """Three rows a slot: the 7-row intensity in blocks of 3, 3 and 1 rows,
    the dB map in one, each widened into the one slot and copied out on the
    current stream; one sync at the end of a call. The outputs are the
    trimmed maps as the host widens or int8-decodes them, bit for bit,
    float32, C-contiguous, over two calls through one read-back."""
    monkeypatch.setattr(recording, "_DECODE_SLOT_BYTES", 3 * 52 * 4)
    rb = _ReadBack()
    spans = []
    monkeypatch.setattr(recording, "span", lambda name: spans.append(name)
                        or contextlib.nullcontext())
    for seed in (0, 1):
        maps = _cpu_maps(seed, codes=codes)
        hosts = rb(maps)
        for h, m in zip(hosts, maps):
            assert h.dtype == torch.float32 and h.is_contiguous()
            assert torch.equal(h.view(torch.int32), _widened(m).view(torch.int32))
    assert fake_read_back == [("sync", "current")] * 2
    assert spans == ["recording.decode_block"] * 2 * 4
    assert rb._slot.numel() == 1024  # 624 bytes, rounded to 512s


def test_host_blocks_come_back_when_dropped(fake_read_back):
    """A block returns to its size's free list once the last array over it
    is dropped, and the next read-back takes it again: with each result
    dropped as the next arrives, no block is taken anew from the third
    call on; a block under a kept array is never handed out; the blocks
    are the maps' bytes rounded up to whole pages."""
    rb = _ReadBack()
    maps = _cpu_maps(2, rows=40)  # blocks of 3 pages and 1 page
    registered, out = [], None
    for _ in range(5):
        out = rb(maps)
        registered.append(rb.host.registered)
    assert registered == [2, 4, 4, 4, 4]
    assert sorted(b.size for b in rb.host._free) == [PAGE, 3 * PAGE]
    kept = out[0].numpy()
    del out
    gc.collect()
    again = rb(maps)  # the other intensity block, free since the 5th call
    assert rb.host.registered == 4
    assert not np.shares_memory(again[0].numpy(), kept)
    third = rb(maps)  # both intensity blocks are held: a third is made
    assert rb.host.registered == 5
    assert not np.shares_memory(third[0].numpy(), kept)
    assert _HostBlocks.block_bytes(40 * 52 * 4) == 3 * PAGE


def test_host_blocks_stay_bounded_over_varying_lengths(fake_read_back, monkeypatch):
    """Recordings of varying valid lengths, each result kept while the next
    is made: a map takes the smallest free block that holds it, so once the
    two longest calls' blocks exist no block is taken anew; the free list
    keeps at most _HOST_BLOCKS_KEPT blocks, the largest, and drops the
    others (unregistered on a card) once no array is over them."""
    dropped = []

    def page_locked(n):
        block = np.empty(n, np.uint8)
        weakref.finalize(block, dropped.append, n)
        return block

    monkeypatch.setattr(recording, "_page_locked", page_locked)
    rb = _ReadBack()
    valid = [4096, 4096, *np.random.default_rng(7).integers(600, 4097, 28).tolist()]
    out, registered = None, []
    for v in valid:
        out = rb(_cpu_maps(v, rows=40, cols=4096, valid=v))
        registered.append(rb.host.registered)
    assert registered == [2] + [4] * 29
    largest = _HostBlocks.block_bytes(40 * 4096 * 4)
    assert sum(b.size for b in rb.host._free) <= 2 * largest
    held = [rb(_cpu_maps(k, rows=40, cols=4096, valid=600)) for k in range(3)]
    assert rb.host.registered == 8  # out's two blocks and the three results' six
    del out, held
    gc.collect()
    kept = recording._HOST_BLOCKS_KEPT
    assert len(rb.host._free) == kept and len(dropped) == 8 - kept
    assert min(b.size for b in rb.host._free) >= max(dropped)
    assert sum(b.size for b in rb.host._free) <= kept * largest


def test_read_back_counts_its_slots_and_blocks(fake_read_back, monkeypatch):
    """Under the profiler, recording.decode_scratch_bytes is the slot's
    bytes and recording.decode_host_alloc_bytes the host blocks' whole
    pages, on each call; a span recording.decode_block a block."""
    monkeypatch.setattr(recording, "_DECODE_SLOT_BYTES", 2 * 52 * 4)
    PROFILED.records.clear()
    monkeypatch.setattr(observe, "_unprofiled_span_since", True)
    rb = _ReadBack()
    with profile(activities=[ProfilerActivity.CPU]):
        for seed in (3, 4):
            rb(_cpu_maps(seed))
    rec = PROFILED.records
    assert rec["recording.decode_scratch_bytes"].items == 2 * 512  # 416 bytes, rounded
    assert rec["recording.decode_host_alloc_bytes"].items == 2 * 2 * PAGE
    assert rec["recording.decode_block"].count == 2 * (4 + 2)  # 7 rows, 3 rows
    PROFILED.records.clear()


def test_read_back_refuses_where_page_locking_fails(fake_read_back, monkeypatch):
    """Where a block cannot be page-locked the read-back returns None and
    copies nothing; the block it had taken goes back to its free list."""
    calls = iter([np.empty(PAGE, np.uint8), None])
    monkeypatch.setattr(recording, "_page_locked", lambda n: next(calls))
    rb = _ReadBack()
    assert rb(_cpu_maps(5)) is None
    gc.collect()
    assert fake_read_back == [] and rb._slot is None
    assert [b.size for b in rb.host._free] == [PAGE]


# --- on the card --------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", PROFILES)
def test_maps_bit_identical_to_pageable_read_back(name, card, monkeypatch):
    """Intensity and dB as the pageable copy widened on the host gives
    them, bit for bit; float32, C-contiguous, [rows, n_valid]."""
    pipe, [(raw, calib)] = _pipeline(name, card)
    seen = _pageable_spy(monkeypatch)
    got = pipe.process_recording(raw, calib)
    assert len(seen) == 1
    intensity, db = seen[0]
    want_intensity = (decode_db_int8(intensity) if intensity.dtype == torch.int8
                      else intensity.to(torch.float32).numpy())
    for g, want in ((got.spectrogram_intensity, want_intensity),
                    (got.spectrogram_psd_db, db.to(torch.float32).numpy())):
        _same_bits(g, want)
        assert g.flags.c_contiguous
    assert got.spectrogram_intensity.shape == tuple(intensity.shape)
    assert got.spectrogram_psd_db.shape == tuple(db.shape)
    assert got.spectrogram_times.shape == (db.shape[1],)


@pytest.mark.cuda
def test_pageable_fallback_where_pinning_raises(card, monkeypatch, tmp_path):
    """Where no host block can be page-locked, the call copies in the
    store dtype through pageable memory: the same maps, no bytes counted
    as page-locked."""
    pipe, [(raw, calib)] = _pipeline("production", card)
    want = pipe.process_recording(raw, calib)
    pipe = RadarPipeline(pipe.cfg, device=card)  # no page-locked block kept
    monkeypatch.setattr(recording, "_page_locked", lambda nbytes: None)
    PROFILED.records.clear()
    monkeypatch.setattr(observe, "_unprofiled_span_since", True)
    with profile(activities=[ProfilerActivity.CPU]):
        got = pipe.process_recording(raw, calib)
    _same_bits(got.spectrogram_intensity, want.spectrogram_intensity)
    _same_bits(got.spectrogram_psd_db, want.spectrogram_psd_db)
    assert PROFILED.records["recording.decode_pinned_bytes"].items == 0
    assert PROFILED.records["recording.decode_copy_bytes"].items == 2 * (
        got.spectrogram_intensity.size + got.spectrogram_psd_db.size)  # bf16


@pytest.mark.cuda
def test_earlier_results_not_overwritten(card):
    """Call 1's maps are unchanged after calls 2 and 3 on other recordings,
    and share no memory with theirs."""
    pipe, recs = _pipeline("production", card, seeds=(1, 2, 3))
    first = pipe.process_recording(*recs[0])
    kept = [first.spectrogram_intensity.copy(), first.spectrogram_psd_db.copy()]
    later = [pipe.process_recording(*r) for r in recs[1:]]
    for out in later:
        assert not np.array_equal(out.spectrogram_psd_db, kept[1])
        for a, b in ((first.spectrogram_intensity, out.spectrogram_intensity),
                     (first.spectrogram_psd_db, out.spectrogram_psd_db)):
            assert not np.shares_memory(a, b)
    _same_bits(first.spectrogram_intensity, kept[0])
    _same_bits(first.spectrogram_psd_db, kept[1])


@pytest.mark.cuda
def test_page_locked_blocks_come_back_from_the_cache(card):
    """With each result dropped once the next arrives, no page-locked
    block is allocated anew from the third call on: neither a block of the
    read-back's own nor one of PyTorch's caching host allocator."""
    pipe, [(raw, calib)] = _pipeline("production", card)
    allocs = []
    out = None
    for _ in range(6):
        out = pipe.process_recording(raw, calib)
        allocs.append((pipe._read_back.host.registered,
                       torch.cuda.host_memory_stats()["num_host_alloc"]))
    assert out.spectrogram_psd_db.size > 0
    assert allocs[2:] == [allocs[2]] * 4, allocs
    assert allocs[2][0] == 4, allocs  # two blocks of each map's size


@pytest.mark.cuda
@pytest.mark.parametrize("name", PROFILES)
def test_counted_bytes_are_the_page_locked_maps(name, card, monkeypatch):
    """Under the profiler, recording.decode_pinned_bytes equals
    recording.decode_copy_bytes: the float32 maps' bytes, the int8
    intensity's too (decoded on the card)."""
    pipe, [(raw, calib)] = _pipeline(name, card)
    pipe.process_recording(raw, calib)  # builds and loads the kernels
    PROFILED.records.clear()
    monkeypatch.setattr(observe, "_unprofiled_span_since", True)
    with profile(activities=[ProfilerActivity.CPU]):
        got = pipe.process_recording(raw, calib)
    want = (got.spectrogram_intensity.size + got.spectrogram_psd_db.size) * 4
    assert PROFILED.records["recording.decode_copy_bytes"].items == want
    assert PROFILED.records["recording.decode_pinned_bytes"].items == want
    PROFILED.records.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("name", PROFILES)
def test_scratch_and_host_counters_are_the_bytes_they_name(name, card, monkeypatch):
    """On a fresh read-back the device's peak allocation grows by
    recording.decode_scratch_bytes, the slot (at most _DECODE_SLOT_BYTES,
    nothing of the maps' size), and by no more than the allocator's
    rounding of its block; the host blocks under the outputs are
    recording.decode_host_alloc_bytes, the maps' float32 bytes rounded up
    to whole pages."""
    pipe, [(raw, calib)] = _pipeline(name, card)
    seen = _pageable_spy(monkeypatch)
    pipe.process_recording(raw, calib)
    monkeypatch.undo()  # the spy's .cpu() of a trimmed view copies it whole on the card
    maps = [m.to(card) for m in seen[0]]
    maps = [torch.cat([m, m[:, :5]], dim=1)[:, : m.shape[1]] for m in maps]  # trimmed views
    rb = _ReadBack()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the slots come from fresh segments
    torch.cuda.reset_peak_memory_stats(card)
    before = torch.cuda.memory_allocated(card)
    PROFILED.records.clear()
    monkeypatch.setattr(observe, "_unprofiled_span_since", True)
    with profile(activities=[ProfilerActivity.CPU]):
        hosts = rb(maps)
    scratch = PROFILED.records["recording.decode_scratch_bytes"].items
    # The caching allocator hands out a segment's tail of under 1 MiB with
    # the block rather than split it off, so each slot may count up to that.
    grown = torch.cuda.max_memory_allocated(card) - before
    assert scratch <= grown < scratch + 2 * (1 << 20)
    assert scratch == rb._slot.numel() <= SLOT
    alloc = PROFILED.records["recording.decode_host_alloc_bytes"].items
    copied = sum(h.numel() * h.element_size() for h in hosts)
    assert alloc == sum(_HostBlocks.block_bytes(h.numel() * 4) for h in hosts)
    assert copied <= alloc < copied + 2 * PAGE
    assert all(h.is_pinned() for h in hosts)
    for h, m in zip(hosts, maps):
        assert torch.equal(h.view(torch.int32), _widened(m.cpu()).view(torch.int32))
    PROFILED.records.clear()


def _signal(length: int, count: int, seed: int = 5) -> np.ndarray:
    """|noise + a tone| over the first ``count`` samples, zeros after."""
    rng = np.random.default_rng(seed)
    sig = np.zeros(length, np.float32)
    sig[:count] = np.abs(rng.standard_normal(count, dtype=np.float32)
                         + 0.5 * np.sin(np.arange(count, dtype=np.float32) * 0.3))
    return sig


@pytest.mark.cuda
@pytest.mark.slow
def test_k2a_k3_and_read_back_past_2_32_elements(card):
    """The production export and read-back of a packed signal of 2^23
    samples, 2^33 intensity elements (a day's 8.5e9 lie past 2^32): K2a's
    PSD and K3's bf16 dB map and intensity on the first and last 2,048
    columns against the plain versions (the tolerances of test_torch_ops.py's K2a and K3 tests; a
    column depends only on its window and gmax, the kernels' own), and the
    read-back's host maps equal to the trimmed device maps, widened, bit
    for bit, in every row."""
    length = 1 << 23
    count = length - 1_000
    op = StftOperator.create(window_length=20, beta=3.0, nfft=256, fs=1000.0, hop=1)
    nb, nb_pad = op.num_bins, -(-op.num_bins // 16) * 16
    t = length - 19
    t_pad = -(-t // stc.PSD_TILE) * stc.PSD_TILE
    n_valid = count - 19
    sig = torch.as_tensor(_signal(length, count), device=card)
    a2 = torch.as_tensor(stc._folded_operator(op, 16), device=card)
    p, tmax = stc.psd_phase1_b3(sig, n_valid, a2, nb_pad, t_pad)
    gmax = tmax.amax()
    db, out = stc.db_rescale(p, gmax, nb, 1024, torch.bfloat16, torch.bfloat16)
    assert out.numel() == 2**33
    for t0 in (0, n_valid - 2048):
        cols = slice(t0, t0 + 2048)
        p_ref = stc.psd_phase1_b3_ref(sig[t0:t0 + 2048 + 19], 2048, a2, nb_pad, 2048)[0]
        assert bool(((p[:, cols] - p_ref).abs()
                     <= 1e-6 * float(gmax) + 1e-4 * p_ref.abs()).all())
        db_ref, out_ref = stc.db_rescale_ref(p[:, cols].contiguous(), gmax, nb, 1024,
                                             torch.bfloat16, torch.bfloat16)
        assert torch.equal(db[:, cols] == DB_FLOOR, db_ref == DB_FLOOR)
        m = db_ref.float() > -120
        torch.testing.assert_close(db[:, cols].float()[m], db_ref.float()[m],
                                   rtol=0, atol=0.5)
        mi = out_ref.float() > -120
        torch.testing.assert_close(out[:, cols].float()[mi], out_ref.float()[mi],
                                   rtol=0, atol=0.5)
    del p
    maps = [out[:, :n_valid], db[:nb, :n_valid]]
    hosts = _ReadBack()(maps)
    assert hosts is not None and hosts[0].shape == (1024, n_valid)
    for h, m in zip(hosts, maps):
        for r0 in range(0, m.shape[0], 16):
            got = h[r0:r0 + 16].to(card)
            assert torch.equal(got.view(torch.int32), m[r0:r0 + 16].float().view(torch.int32))
