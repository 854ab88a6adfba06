"""PyTorch port: the recording's maps read back on the card
(pipeline/recording.py::_pinned_read_back).

On a CUDA device each trimmed map is widened to float32 on the card (int8
stays int8) and copied once into page-locked host memory taken per call
from PyTorch's caching host allocator; the returned arrays are NumPy views
of those buffers. The values are the pageable read-back's, bit for bit:
``.cpu()`` of the trimmed store, then widened (or int8-decoded) on the host.
Every test here needs a card; the CPU path is held unchanged by
``tests/test_torch_observe.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fmcw_radar_processing_tpu_torch.config import (
    AlgorithmConfig,
    RadarConfig,
    default_device_config,
)
from fmcw_radar_processing_tpu_torch.dsp.stft import decode_db_int8
from fmcw_radar_processing_tpu_torch.io.synth import SyntheticTarget, synthesize_recording
from fmcw_radar_processing_tpu_torch.pipeline import recording
from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline
from fmcw_radar_processing_tpu_torch.utils import observe
from fmcw_radar_processing_tpu_torch.utils.observe import PROFILED

FRAMES = 1024
TARGETS = (SyntheticTarget(range_m=7.5, doppler_bin_offset=3),
           SyntheticTarget(range_m=16.9, doppler_bin_offset=-2))
PROFILES = ("production", "fidelity", "int8")


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
    """Wrap _pinned_read_back so that each call first records the pageable
    read-back of its maps: ``.cpu()`` of the trimmed store."""
    seen = []
    real = recording._pinned_read_back

    def spy(maps):
        seen.append([m.cpu() for m in maps])
        return real(maps)

    monkeypatch.setattr(recording, "_pinned_read_back", spy)
    return seen


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
    """Where the page-locked allocation raises, the call copies in the
    store dtype through pageable memory: the same maps, no bytes counted
    as page-locked."""
    pipe, [(raw, calib)] = _pipeline("production", card)
    want = pipe.process_recording(raw, calib)
    real_empty = torch.empty

    def no_pinning(*args, pin_memory=False, **kwargs):
        if pin_memory:
            raise RuntimeError("CUDA error: out of memory")
        return real_empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", no_pinning)
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
    block is allocated anew from the third call on."""
    pipe, [(raw, calib)] = _pipeline("production", card)
    allocs = []
    out = None
    for _ in range(6):
        out = pipe.process_recording(raw, calib)
        allocs.append(torch.cuda.host_memory_stats()["num_host_alloc"])
    assert out.spectrogram_psd_db.size > 0
    assert allocs[2:] == [allocs[2]] * 4, allocs


@pytest.mark.cuda
@pytest.mark.parametrize("name", PROFILES)
def test_counted_bytes_are_the_page_locked_maps(name, card, monkeypatch):
    """Under the profiler, recording.decode_pinned_bytes equals
    recording.decode_copy_bytes: the float32 maps' bytes, the int8
    intensity at one byte."""
    pipe, [(raw, calib)] = _pipeline(name, card)
    pipe.process_recording(raw, calib)  # builds and loads the kernels
    PROFILED.records.clear()
    monkeypatch.setattr(observe, "_unprofiled_span_since", True)
    with profile(activities=[ProfilerActivity.CPU]):
        got = pipe.process_recording(raw, calib)
    per = 1 if name == "int8" else 4
    want = got.spectrogram_intensity.size * per + got.spectrogram_psd_db.size * 4
    assert PROFILED.records["recording.decode_copy_bytes"].items == want
    assert PROFILED.records["recording.decode_pinned_bytes"].items == want
    PROFILED.records.clear()
