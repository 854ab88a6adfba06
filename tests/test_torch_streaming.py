"""PyTorch port: the streaming multi-channel processor vs the JAX package.

The port's StreamingProcessor on the CPU (the kernels' plain versions) is
held to the JAX package's StreamingProcessor (mesh None) window by window,
on two channels with different targets and mute patterns, in both dB
modes; it is also held to its own window-split invariance, as the JAX
tests hold the JAX processor. Tolerances: the frame chain's bounds
(ROADMAP.md, Queue 1 item 3) for the per-frame outputs, the STFT bounds of
tests/test_stft_pallas.py for the spectrogram.
"""

import numpy as np
import pytest
import torch

from fmcw_radar_processing_tpu.dsp.stft import StftOperator as JaxStftOperator
from fmcw_radar_processing_tpu.pipeline.streaming import (
    StreamingProcessor as JaxStreamingProcessor,
)
from fmcw_radar_processing_tpu.pipeline.streaming import (
    normalize_two_pass as jax_normalize_two_pass,
)
from fmcw_radar_processing_tpu_torch.dsp.stft import DB_FLOOR, StftOperator, psd_db
from fmcw_radar_processing_tpu_torch.pipeline.streaming import (
    StreamingProcessor,
    normalize_two_pass,
)
from fmcw_radar_processing_tpu_torch.utils.cplx import to_pair

from .conftest import make_recording

WINDOWS = (8, 4, 8)  # frames per window


def _channel(cfg, rng, frames, target_bins, muted, calib_gain):
    """One channel's [F, PN, NTS, 2] pair frames, targets absent on the
    ``muted`` frames, and its [NTS, 2] calibration."""
    frames_c, calib = make_recording(cfg, frames, rng, target_bins=target_bins)
    # Weak noise alone on the muted frames (as tests/test_pipeline.py's
    # _mixed_recording): nothing there crosses the detection threshold.
    shape = frames_c[list(muted)].shape
    frames_c[list(muted)] = 0.003 * (rng.standard_normal(shape)
                                     + 1j * rng.standard_normal(shape))
    raw = to_pair(np.swapaxes(frames_c, -1, -2))
    return raw, to_pair(calib * np.complex64(calib_gain))


@pytest.fixture
def two_channels(cfg, rng):
    n = sum(WINDOWS)
    a = _channel(cfg, rng, n, (40, 90), (1, 2, 9, 13, 17), 1.0)
    b = _channel(cfg, rng, n, (60,), (0, 5, 6, 7, 12, 19), 0.5 - 0.2j)
    return np.stack([a[0], b[0]]), np.stack([a[1], b[1]])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _assert_window_equal(got, want):
    np.testing.assert_array_equal(_np(got.detected), _np(want.detected))
    np.testing.assert_array_equal(_np(got.col_count), _np(want.col_count))
    np.testing.assert_allclose(_np(got.waterfall), _np(want.waterfall),
                               rtol=1e-5, atol=1e-2)
    for name, atol in (("range", 0.0), ("speed", 1e-7), ("strength", 1e-2)):
        g, w = _np(getattr(got, name)), _np(getattr(want, name))
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        rtol = 1e-5 if name == "strength" else 1e-6
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, equal_nan=True)
    # PSD within 1e-4 of each channel's window max.
    p, pw = _np(got.psd), _np(want.psd)
    scale = pw.max(axis=(-2, -1), keepdims=True)
    assert np.all(np.abs(p - pw) <= 1e-4 * scale)
    db, dbw = _np(got.psd_db), _np(want.psd_db)
    np.testing.assert_array_equal(db == DB_FLOOR, dbw == DB_FLOOR)
    # The two frame chains give streams that agree to about 7e-7 relative;
    # deep bins amplify that by cancellation (up to 1.7e-3 dB measured
    # between −120 and −110 dB, 5.4e-4 dB above −100 dB). So: 1e-3 dB
    # above −100 dB, 2e-3 dB above −120 dB,
    # and the normalization alone, on JAX's own PSD, 1e-3 dB above −120 dB.
    for lvl, atol in ((-100.0, 1e-3), (-120.0, 2e-3)):
        band = dbw > lvl
        np.testing.assert_allclose(db[band], dbw[band], rtol=0, atol=atol)
    norm = torch.as_tensor(_np(want.norm_power))[:, None, None]
    db_same = psd_db(torch.as_tensor(pw), norm).numpy()
    band = dbw > -120.0
    np.testing.assert_allclose(db_same[band], dbw[band], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(db_same == DB_FLOOR, dbw == DB_FLOOR)
    np.testing.assert_allclose(_np(got.norm_power), _np(want.norm_power),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(got.carry), _np(want.carry), rtol=1e-5)


@pytest.mark.parametrize("db_mode", ["per_window", "running_max"])
def test_streaming_matches_jax(cfg, two_channels, db_mode):
    raw, cal = two_channels
    port = StreamingProcessor(cfg, channels=2, window_frames=8, device="cpu",
                              db_mode=db_mode)
    ref = JaxStreamingProcessor(cfg, channels=2, window_frames=8,
                                db_mode=db_mode)
    start = 0
    for f in WINDOWS:
        got = port.process_window(raw[:, start:start + f], cal)
        want = ref.process_window(raw[:, start:start + f], cal)
        _assert_window_equal(got, want)
        start += f
    # Both channels detect on some frames and not on others, and every
    # window produced columns.
    assert 0 < int(_np(got.detected).sum()) < got.detected.numel()
    assert np.all(_np(got.col_count) > 0)


def test_flat_rows_equal_pair_layout(cfg, two_channels):
    raw, cal = two_channels
    flat = raw.reshape(*raw.shape[:3], -1)
    a = StreamingProcessor(cfg, 2, 8, "cpu").process_window(raw[:, :8], cal)
    b = StreamingProcessor(cfg, 2, 8, "cpu").process_window(flat[:, :8], cal)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def test_window_split_invariance(cfg, two_channels):
    """Splitting a channel's frames into windows, with the W−1 carry, gives
    the same STFT columns as one window (the JAX test_streaming.py case)."""
    raw, cal = two_channels
    raw, cal = raw[:1, :8], cal[:1]
    full = StreamingProcessor(cfg, 1, 8, "cpu").process_window(raw, cal)
    n_full = int(full.col_count[0])
    assert n_full > 0
    split = StreamingProcessor(cfg, 1, 4, "cpu")
    r1 = split.process_window(raw[:, :4], cal)
    r2 = split.process_window(raw[:, 4:], cal)
    n1, n2 = int(r1.col_count[0]), int(r2.col_count[0])
    assert n1 + n2 == n_full
    got = np.concatenate([_np(r1.psd[0])[:, :n1], _np(r2.psd[0])[:, :n2]],
                         axis=1)
    want = _np(full.psd[0])[:, :n_full]
    assert np.all(np.abs(got - want) <= 1e-5 * want.max())
    np.testing.assert_allclose(_np(r2.waterfall[0]), _np(full.waterfall[0])[4:],
                               rtol=1e-6)


def test_short_window_carry(cfg, two_channels):
    """Windows shorter than the STFT window still accumulate seamlessly."""
    raw, cal = two_channels
    raw, cal = raw[1:, 8:12], cal[1:]
    full = StreamingProcessor(cfg, 1, 4, "cpu").process_window(raw, cal)
    n_full = int(full.col_count[0])
    split = StreamingProcessor(cfg, 1, 1, "cpu")
    cols, ns = [], []
    for f in range(4):
        r = split.process_window(raw[:, f:f + 1], cal)
        k = int(r.col_count[0])
        ns.append(k)
        if k:
            cols.append(_np(r.psd[0])[:, :k])
    assert sum(ns) == n_full and 0 in ns  # one window was shorter than W
    got = np.concatenate(cols, axis=1)
    want = _np(full.psd[0])[:, :n_full]
    assert np.all(np.abs(got - want) <= 1e-5 * want.max())


def test_reset_and_bad_arguments(cfg, two_channels):
    raw, cal = two_channels
    sp = StreamingProcessor(cfg, 2, 8, "cpu")
    first = sp.process_window(raw[:, :8], cal)
    sp.process_window(raw[:, 8:12], cal)
    sp.reset()
    again = sp.process_window(raw[:, :8], cal)
    torch.testing.assert_close(again.psd, first.psd, rtol=0, atol=0)
    with pytest.raises(ValueError, match="channels"):
        sp.process_window(raw[:1, :8], cal[:1])
    with pytest.raises(ValueError, match="db_mode"):
        StreamingProcessor(cfg, 2, 8, "cpu", db_mode="global")


def test_stft_call_matches_jax(cfg):
    rng = np.random.default_rng(7)
    x = np.abs(rng.standard_normal((2, 3, 150))).astype(np.float32)
    valid = np.array([[150, 90, 19], [40, 20, 0]], np.int32)
    kw = dict(window_length=20, beta=3.0, nfft=256, fs=1.0 / cfg.derived.prt)
    got = StftOperator.create(**kw)(torch.as_tensor(x), torch.as_tensor(valid))
    want = JaxStftOperator.create(**kw)(x, valid_len=valid)
    p, pw = got.power.numpy(), np.asarray(want.power)
    assert p.shape == pw.shape == (2, 3, 129, 131)
    assert np.all(np.abs(p - pw) <= 1e-4 * pw.max())
    np.testing.assert_array_equal(got.frame_valid.numpy(),
                                  np.asarray(want.frame_valid))
    np.testing.assert_array_equal(got.freqs.numpy(), np.asarray(want.freqs))
    np.testing.assert_array_equal(got.times.numpy(), np.asarray(want.times))
    # No valid_len: every column valid.
    full = StftOperator.create(**kw)(torch.as_tensor(x[0, 0]))
    assert bool(full.frame_valid.all()) and full.power.shape == (129, 131)


def test_normalize_two_pass_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    psds = [np.abs(rng.standard_normal((2, 5, 9))).astype(np.float32)
            * rng.uniform(0.5, 4.0) for _ in range(3)]
    counts = [np.array([9, 4]), np.array([0, 7]), np.array([6, 9])]
    psds[1][0] = 0.0  # a window with no valid column on channel 0
    psds[2][1, :, 3] = 0.0  # zero power inside the valid columns
    got = normalize_two_pass(psds, counts)
    want = jax_normalize_two_pass(psds, counts)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
