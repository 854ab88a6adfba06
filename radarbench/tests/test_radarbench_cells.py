"""Whole runs of the one-card cells on the CPU at a tiny size: the program
comes out correct, traced and untraced; the control (the configuration's
lower-precision paths in the program's place) and each fault planted in
the timed path come out not correct. The look for a card is what run.py
adds; the harness below it runs here as on the card."""

from __future__ import annotations

import numpy as np
import pytest

from radarbench import harness
from radarbench.tests.conftest import one_card_cells

ONE_CARD = one_card_cells()
SEED = 2**31 + 12345


@pytest.mark.parametrize("traced", (False, True))
@pytest.mark.parametrize("cell", ONE_CARD)
def test_program_is_correct(tiny_root, cell, traced):
    r = harness.run_cell(tiny_root, cell, SEED, 0.2, traced, "cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    if traced:
        assert r["device"]["window_s"] > 0
    else:
        assert "setup_s" in r["metrics"]


@pytest.mark.parametrize("cell", ONE_CARD)
def test_control_is_not_correct(tiny_root, cell):
    r = harness.run_cell(tiny_root, cell, SEED + 1, 0.2, False, "cpu", variant="control")
    assert not r["correct"], r["checks"]


def _recording_pipeline():
    from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline

    return RadarPipeline


def _streaming_processor():
    from fmcw_radar_processing_tpu_torch.pipeline.streaming import StreamingProcessor

    return StreamingProcessor


def test_state_returned_unchanged_fails(tiny_root, monkeypatch):
    """The stream's carry never moves on: each window starts afresh."""
    sp = _streaming_processor()
    orig = sp.process_window

    def frozen(self, raw, calib):
        out = orig(self, raw, calib)
        self.reset()
        return out

    monkeypatch.setattr(sp, "process_window", frozen)
    r = harness.run_cell(tiny_root, "stream-8ch.windows", SEED, 0.2, False, "cpu")
    assert not r["correct"] and r["checks"]["detect_faults"]["value"] > 0


def test_half_of_the_recording_left_out_fails(tiny_root, monkeypatch):
    rp = _recording_pipeline()
    orig = rp.process_recording

    def half(self, raw, calib, timer=None):
        return orig(self, raw[: raw.shape[0] // 2], calib, timer=timer)

    monkeypatch.setattr(rp, "process_recording", half)
    r = harness.run_cell(tiny_root, "production-65k.recording", SEED, 0.2, False, "cpu")
    assert not r["correct"]


def test_half_of_the_channels_left_out_fails(tiny_root, monkeypatch):
    """Half of the stream's channels get the other half's results."""
    sp = _streaming_processor()
    orig = sp.process_window

    def half(self, raw, calib):
        out = orig(self, raw, calib)
        h = out.waterfall.shape[0] // 2
        return out._replace(**{k: getattr(out, k)[:h].repeat(2, *[1] * (getattr(out, k).dim() - 1))
                               for k in ("waterfall", "range", "speed", "strength",
                                         "detected", "psd_db", "col_count")})

    monkeypatch.setattr(sp, "process_window", half)
    r = harness.run_cell(tiny_root, "stream-8ch.windows", SEED, 0.2, False, "cpu")
    assert not r["correct"]


def test_an_answer_altered_fails(tiny_root, monkeypatch):
    """One frame's range moved by a bin, where the payload is built."""
    rp = _recording_pipeline()
    orig = rp.process_recording

    def altered(self, raw, calib, timer=None):
        out = orig(self, raw, calib, timer=timer)
        rs = out.payloads[f"{self.filename}_range_speed_data.json"]["range"]
        first = int(np.flatnonzero(~np.isnan(rs[0]))[0])
        rs[0, first] += self.cfg.derived.dist_per_bin
        return out

    monkeypatch.setattr(rp, "process_recording", altered)
    r = harness.run_cell(tiny_root, "production-65k.recording", SEED, 0.2, False, "cpu")
    assert not r["correct"] and r["checks"]["detect_faults"]["value"] > 0


def test_a_batch_spectrogram_altered_fails(tiny_root, monkeypatch):
    """One activity batch's strongest intensity value moved by 1 dB where
    it is made."""
    rp = _recording_pipeline()
    orig = rp.process_activity

    def altered(self, raw, calib):
        out = orig(self, raw, calib)
        inten = out[-1].payload["intensity"]
        inten[np.unravel_index(np.argmax(inten), inten.shape)] -= 1.0
        return out

    monkeypatch.setattr(rp, "process_activity", altered)
    r = harness.run_cell(tiny_root, "production-65k.activity", SEED, 0.2, False, "cpu")
    assert not r["correct"] and r["checks"]["intensity_err"]["value"] > 0.01


SP4 = "production-65k-sp4.recording"


def test_sharded_program_correct_and_control_not(tiny_root):
    """The four-card cell rehearsed on the CPU: four gloo ranks, rank 0
    here, the others spawned."""
    r = harness.run_cell(tiny_root, SP4, SEED, 0.2, False, "cpu")
    assert r["correct"], r["checks"]
    assert r["device"]["count"] == 4
    c = harness.run_cell(tiny_root, SP4, SEED + 1, 0.2, False, "cpu", variant="control")
    assert not c["correct"], c["checks"]


def test_the_exchange_between_chips_left_out_fails(tiny_root):
    """Every rank's STFT without its neighbour's 19-sample halo."""
    import json

    path = tiny_root / "radarbench" / "configs" / "production-65k-sp4.json"
    cfg = json.loads(path.read_text())
    cfg["fault"] = "no_halo"
    path.write_text(json.dumps(cfg))
    r = harness.run_cell(tiny_root, SP4, SEED, 0.2, False, "cpu")
    assert not r["correct"] and r["checks"]["db_err"]["value"] > 0.1
