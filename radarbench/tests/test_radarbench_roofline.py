"""The least-work counts from shapes: the production recording, the
activity request and a streamed window, and the fidelity profile's nfft
where its stft_nfft is null."""

from __future__ import annotations

import json
import math

import pytest

from radarbench import roofline
from radarbench.tests.conftest import FIDELITY, REPO

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


BARE = {**CFG, "name": "bare", "algorithm": {**CFG["algorithm"], **FIDELITY}}


@pytest.mark.parametrize("columns,nfft", [(14717, 16384), (7357, 8192), (16365, 16384),
                                          (16366, 32768), (237, 256)])
def test_a_null_nfft_follows_the_valid_sample_count(columns, nfft):
    """nfft = next_pow2(columns + W − 1), the program's rule at hop 1; a set
    stft_nfft stays as it is."""
    assert roofline.stft_nfft(BARE, columns) == nfft
    assert roofline.stft_nfft(CFG, columns) == 256
    w = roofline.recording_work(BARE, 1024, columns)
    assert w["export"]["bytes"] == columns * (1024 + nfft // 2 + 1) * 4  # float32 maps
    assert w["export"]["flops"] == pytest.approx(2.5 * nfft * math.log2(nfft) * columns
                                                 + 3 * 1024 * columns)


def test_a_null_nfft_at_a_hop_above_one_raises():
    hop2 = {**BARE, "algorithm": {**BARE["algorithm"], "stft_hop": 2}}
    with pytest.raises(ValueError, match="bare"):
        roofline.recording_work(hop2, 1024, 7000)
    with pytest.raises(ValueError, match="bare"):
        roofline.activity_work(hop2, 1024, [1421])


# The totals as the parent computed them, to the bit; "export" is new.
PINNED = {
    "recording": {"bytes": 2780988314.0, "flops": 18489122816.0},
    "recording_sp4": {"bytes": 1239286093.0, "flops": 4622280704.0},
    "activity": {"bytes": 548512256, "flops": 10804953088.0},
}


@pytest.mark.parametrize("cfg", [CFG, STREAM], ids=["production-65k", "stream-8ch"])
def test_totals_are_the_parents(cfg):
    works = {"recording": roofline.recording_work(cfg, F, COLS),
             "recording_sp4": roofline.recording_work(cfg, F, COLS, ranks=4),
             "activity": roofline.activity_work(cfg, F, [1421] * 4)}
    for name, w in works.items():
        assert {k: w[k] for k in ("bytes", "flops")} == PINNED[name], name
        assert 0 < w["export"]["bytes"] <= w["bytes"] and 0 < w["export"]["flops"] <= w["flops"]
    assert roofline.stream_window_work(STREAM) == {"bytes": 52721664, "flops": 503971840.0}
