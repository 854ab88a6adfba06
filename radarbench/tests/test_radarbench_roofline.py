"""The least-work counts from shapes: the production recording, the
activity request and a streamed window."""

from __future__ import annotations

import json

import pytest

from radarbench import roofline
from radarbench.tests.conftest import REPO

CFG = json.loads((REPO / "radarbench" / "configs" / "production-65k.json").read_text())
STREAM = json.loads((REPO / "radarbench" / "configs" / "stream-8ch.json").read_text())
F = 65536
COLS = (F - round(0.1 * F)) * 16 - 19  # detected frames' chirps, less W - 1


def test_production_recording_is_bytes_bound():
    w = roofline.recording_work(CFG, F, COLS)
    raw = F * 16 * 128 * 4
    maps = COLS * (1024 * 2 + 129 * 2)  # bf16 intensity and dB map
    assert w["bytes"] == pytest.approx(raw + 512 + F * (256 * 4 + 13) + maps)
    assert w["bytes"] == pytest.approx(2.78e9, rel=0.01)
    t, by = roofline.least_seconds(w["bytes"], w["flops"])
    assert by == "bytes" and t == pytest.approx(0.83e-3, rel=0.01)
    # range FFTs: 1,048,576 chirps of 256 points; STFT: real 256-point per column
    assert w["flops"] == pytest.approx(5 * 256 * 8 * F * 16 + 5 * 16 * 4 * F
                                       + 2.5 * 256 * 8 * COLS + 3 * 1024 * COLS)


def test_sharded_share_is_a_quarter_with_float32_maps():
    one = roofline.recording_work(CFG, F, COLS)
    four = roofline.recording_work(CFG, F, COLS, ranks=4)
    extra = COLS * (1024 * 2 + 129 * 2)  # float32 maps: two more bytes a value
    assert four["bytes"] * 4 == pytest.approx(one["bytes"] + extra)
    assert four["flops"] * 4 == pytest.approx(one["flops"])


def test_activity_and_stream_counts():
    a = roofline.activity_work(CFG, F, [1421] * 4)
    assert a["bytes"] == pytest.approx(F * 16 * 128 * 4 + 512 + 4 * 1421 * 1024 * 2)
    s = roofline.stream_window_work(STREAM)
    per = 256 * 16 * 128 * 4 + 512 + 256 * (256 * 4 + 13) + 2 * 129 * 4096 * 4
    assert s["bytes"] == pytest.approx(8 * per)
    t, by = roofline.least_seconds(s["bytes"], s["flops"])
    assert by == "bytes" and t == pytest.approx(8 * per / 3.35e12)
