"""PyTorch port: the streaming multi-channel processor vs the JAX package.

The port's StreamingProcessor on the CPU (the kernels' plain versions) is
held to the JAX package's StreamingProcessor (mesh None) window by window,
on two channels with different targets and mute patterns, in both dB
modes; it is also held to its own window-split invariance, as the JAX
tests hold the JAX processor. Tolerances: the frame chain's bounds
(ROADMAP.md, Queue 1 item 3) for the per-frame outputs, the STFT bounds of
tests/test_stft_pallas.py for the spectrogram.

The ``cuda`` tests hold the card's CUDA-graph path to the card's eager
path: bit-equal results, results that later windows leave alone, and the
same kernel launches a window; and the card's windows at the streaming
benchmark's shape to the injected targets and to the CPU plain path.
"""

import dataclasses

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
from torch.profiler import ProfilerActivity, profile

from fmcw_radar_processing_tpu_torch.config import (
    AlgorithmConfig,
    RadarConfig,
    default_device_config,
)
from fmcw_radar_processing_tpu_torch.dsp.detection import _gate_on
from fmcw_radar_processing_tpu_torch.dsp.stft import DB_FLOOR, StftOperator, psd_db
from fmcw_radar_processing_tpu_torch.io.synth import SyntheticTarget, synthesize_recording
from fmcw_radar_processing_tpu_torch.ops import _lib
from fmcw_radar_processing_tpu_torch.pipeline.streaming import (
    StreamingProcessor,
    _Operands,
    normalize_two_pass,
)
from fmcw_radar_processing_tpu_torch.utils.cplx import pin_f32_matmul, to_pair
from fmcw_radar_processing_tpu_torch.utils.observe import PROFILED

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


def test_capture_keeps_the_tensors_it_did_not_make():
    """_Operands keeps every tensor read under it that no operation under it
    returned (inputs, constants, views of them, through lists), and none
    that it made, across two entries."""
    const, x = torch.arange(6.0), torch.ones(6)
    keep = _Operands()
    with keep:
        a = torch.empty(6)
        a.copy_(x)
        b = a * const
        c = torch.stack([b[1:4] + 1, const[:3]])
        d = torch.zeros(2, 3) + c
    with keep:
        torch.cat([d, x.view(2, 3)[:, :1]], dim=1)
    kept = {id(t) for t in keep.kept.values()}
    assert kept == {id(x), id(const)}


# --- on the card: windows replayed from CUDA graphs --------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pin_f32_matmul()
    return torch.device("cuda")


def _card_stream(channels, lengths, seed):
    """The production config and consecutive windows of ``lengths`` frames
    from ``channels`` channels ([C, F, PN, NTS, 2] each, every fifth frame
    muted on channel 0, every third on the others), with the channels'
    [C, NTS, 2] calibration."""
    cfg = RadarConfig.create(default_device_config(), AlgorithmConfig.production())
    rng = np.random.default_rng(seed)
    n = sum(lengths)
    chans = [_channel(cfg, rng, n, (40, 90) if c % 2 else (60,),
                      range(c % 3, n, 5 if c == 0 else 3), 1.0 - 0.25j * c)
             for c in range(channels)]
    raw = np.stack([r for r, _ in chans]).astype(np.float32)
    cuts = np.cumsum((0,) + tuple(lengths))
    windows = [np.ascontiguousarray(raw[:, a:b]) for a, b in zip(cuts, cuts[1:])]
    return cfg, windows, np.stack([c for _, c in chans]).astype(np.float32)


def _eager(proc):
    """``proc`` with every window on the eager path."""
    proc._graphs_for = lambda raw_shape, calib_shape: None
    return proc


def _assert_results_equal(got, want, where):
    for field in want._fields:
        torch.testing.assert_close(getattr(got, field), getattr(want, field),
                                   rtol=0, atol=0, equal_nan=True,
                                   msg=lambda m: f"{where}, {field}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("db_mode", ["per_window", "running_max"])
def test_graph_windows_bit_equal_to_eager(card, db_mode):
    """Replayed windows equal an eager processor's fed the same windows, bit
    for bit, across a reset() and a second window length (a new shape,
    captured at its own first window)."""
    lengths = (32, 32, 32, 32, 16, 32, 16, 16)
    cfg, windows, cal = _card_stream(3, lengths, seed=11)
    graph, eager = (StreamingProcessor(cfg, 3, 32, device=card, nfft=256,
                                       db_mode=db_mode) for _ in range(2))
    _eager(eager)
    for i, w in enumerate(windows):
        if i == 3:
            graph.reset()
            eager.reset()
        _assert_results_equal(graph.process_window(w, cal),
                              eager.process_window(w, cal), f"window {i}")
    shapes = {key[0][1] for key, g in graph._graphs.items() if g.captured}
    assert shapes == {32, 16} and eager._graphs == {}


@pytest.mark.cuda
def test_graph_windows_outlive_evicted_constants(card):
    """A replay reads no memory that a cache has given back: with the gate
    mask pushed out of dsp/detection.py::_gate_on by more other configs
    than it keeps, and every free block of the allocator's small pool
    written with zeros (a zero gate detects nothing), replayed windows
    still equal an eager processor's bit for bit."""
    cfg, windows, cal = _card_stream(2, (32,) * 5, seed=7)
    graph, eager = (StreamingProcessor(cfg, 2, 32, device=card, nfft=256)
                    for _ in range(2))
    _eager(eager)
    others = [RadarConfig.create(default_device_config(),
                                 AlgorithmConfig.production(min_distance=1.0 + j))
              for j in range(_gate_on.cache_info().maxsize + 1)]
    for i, w in enumerate(windows):
        junk = []
        if i >= 2:
            for other in others:
                _gate_on(other, card)
            stats = torch.cuda.memory_stats(card)
            free = (stats["reserved_bytes.small_pool.current"]
                    - stats["allocated_bytes.small_pool.current"])
            junk = [torch.zeros(512, dtype=torch.uint8, device=card)
                    for _ in range(free // 512 + 1)]
        got = graph.process_window(w, cal)
        want = eager.process_window(w, cal)
        assert bool(want.detected.any())
        _assert_results_equal(got, want, f"window {i}")
        del junk
    assert all(g.captured for g in graph._graphs.values())


@pytest.mark.cuda
def test_graph_results_stay_the_callers(card):
    """A returned result, from the capturing window or a replayed one, is
    unchanged by the windows after it."""
    cfg, windows, cal = _card_stream(2, (32,) * 4, seed=5)
    proc = StreamingProcessor(cfg, 2, 32, device=card, nfft=256,
                              db_mode="running_max")
    results = [proc.process_window(windows[0], cal)]
    kept = [[t.clone() for t in results[0]]]
    for w in windows[1:]:
        results.append(proc.process_window(w, cal))
        kept.append([t.clone() for t in results[-1]])
    for i, (res, want) in enumerate(zip(results, kept)):
        _assert_results_equal(res, type(res)(*want), f"window {i}")


@pytest.mark.cuda
def test_graph_windows_launch_and_span_once(card, tmp_path):
    """Each window counts the same kernel launches on the eager and the
    replayed path (the capture counts none); under the profiler a replayed
    window opens stream.chain and stream.graph_replay once."""
    cfg, windows, cal = _card_stream(2, (32,) * 4, seed=3)
    counts = []
    for proc in (_eager(StreamingProcessor(cfg, 2, 32, device=card, nfft=256)),
                 StreamingProcessor(cfg, 2, 32, device=card, nfft=256)):
        per_window = []
        for w in windows[:3]:
            _lib.reset_launches()
            proc.process_window(w, cal)
            per_window.append({k: n for k, n in _lib.LAUNCHES.items() if n})
        counts.append(per_window)
    assert counts[0] == counts[1] == [{"fast_time_profile_b3": 2}] * 3
    with profile(activities=[ProfilerActivity.CPU]):
        proc.process_window(windows[3], cal)
    assert {k: r.count for k, r in PROFILED.records.items()} == {
        "stream.upload": 1, "stream.chain": 1, "stream.graph_replay": 1,
        "stream.stft": 1}


def _snr_db(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    err = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    return -20.0 * float(np.log10(max(err, 1e-30)))


@pytest.mark.cuda
def test_card_windows_match_the_cpu_plain_path(card):
    """The streaming benchmark's shape on the card: the production profile,
    8 channels, 4 windows of 256 frames each from host arrays, a target of
    its own on every channel and about a tenth of the frames muted. K1a
    runs once a channel and window and nothing else does; every channel
    detects its frames with targets, at its target's range and speed; the
    columns over the windows are the detected samples less 19 a channel.
    The first window (eager) and the second (replayed from the CUDA
    graphs) against the port's CPU plain path fed the same windows (its
    "auto" is the exact profile, the card's K1a's bf16x3): detections and
    column counts equal, the waterfall within 100 dB, ranges and speeds at
    rtol 1e-6, the PSD within 1e-4 of the max, the dB map within 1e-3 dB
    above -100 dB and 2e-3 above -120 with its floors in the same places,
    the norms and the carry at rtol 1e-5. Channel 0's four windows equal
    one window of its 1,024 frames on the card, within 1e-5 of the max."""
    channels, window, windows = 8, 256, 4
    frames = window * windows
    cfg = RadarConfig.create(default_device_config(), AlgorithmConfig.production())
    step = np.float32(-cfg.derived.fd_per_bin * cfg.derived.hz_to_mps)
    rng = np.random.default_rng(20261019)
    raws, cals, present, want_rng, want_spd = [], [], [], [], []
    for c in range(channels):
        tgt = SyntheticTarget(range_m=4.5 + 1.6 * c,
                              doppler_bin_offset=(3, -2, 1, -4, 2, -1, 4, -3)[c],
                              amplitude=4.0)
        pres = rng.random(frames) >= 0.1
        rec = synthesize_recording(cfg, frames, (tgt,), seed=20261026 + c,
                                   target_present=pres)
        raws.append(to_pair(rec.rx1()).reshape(frames, cfg.pn, 2 * cfg.nts))
        cals.append(to_pair(rec.calib_vector(0, cfg.nts)))
        present.append(pres)
        want_rng.append(np.float32(tgt.range_bin(cfg)) * np.float32(cfg.derived.dist_per_bin))
        want_spd.append(np.float32(tgt.doppler_bin_offset) * step)
    raw, cal, present = np.stack(raws), np.stack(cals), np.stack(present)
    cuts = [slice(i * window, (i + 1) * window) for i in range(windows)]

    proc = StreamingProcessor(cfg, channels, window, card)
    torch.cuda.synchronize()
    _lib.reset_launches()
    got = [proc.process_window(raw[:, cut], cal) for cut in cuts]
    torch.cuda.synchronize()
    assert {k: n for k, n in _lib.LAUNCHES.items() if n} == {
        "fast_time_profile_b3": channels * windows}
    for r, cut in zip(got, cuts):
        det = r.detected.cpu().numpy()
        np.testing.assert_array_equal(det, present[:, cut])
        rg, sd = r.range.cpu().numpy()[:, 0], r.speed.cpu().numpy()[:, 0]
        for c in range(channels):
            assert np.all(rg[c, det[c]] == want_rng[c])
            assert np.all(np.isnan(rg[c, ~det[c]]))
            assert np.all(sd[c, det[c]] == want_spd[c])
    cols = sum(r.col_count.cpu().numpy().astype(np.int64) for r in got)
    np.testing.assert_array_equal(cols, present.sum(1) * cfg.pn - 19)

    cpu = StreamingProcessor(cfg, channels, window, "cpu")
    for g, cut in zip(got[:2], cuts):
        want = cpu.process_window(raw[:, cut], cal)
        assert torch.equal(g.detected.cpu(), want.detected)
        assert torch.equal(g.col_count.cpu(), want.col_count)
        assert _snr_db(g.waterfall.cpu(), want.waterfall) >= 100.0
        for name, atol in (("range", 0.0), ("speed", 1e-7)):
            torch.testing.assert_close(getattr(g, name).cpu(), getattr(want, name),
                                       rtol=1e-6, atol=atol, equal_nan=True)
        scale = want.psd.amax(dim=(-2, -1), keepdim=True)
        assert float(((g.psd.cpu() - want.psd).abs() / scale).max()) <= 1e-4
        db, dbw = g.psd_db.cpu(), want.psd_db
        assert torch.equal(db == DB_FLOOR, dbw == DB_FLOOR)
        assert float((db - dbw).abs()[dbw > -100].max()) <= 1e-3
        assert float((db - dbw).abs()[dbw > -120].max()) <= 2e-3
        for name in ("norm_power", "carry"):
            torch.testing.assert_close(getattr(g, name).cpu(), getattr(want, name),
                                       rtol=1e-5, atol=0)

    whole = StreamingProcessor(cfg, 1, frames, card).process_window(raw[:1], cal[:1])
    n = [int(r.col_count[0]) for r in got]
    assert sum(n) == int(whole.col_count[0])
    split = torch.cat([r.psd[0, :, :k] for r, k in zip(got, n)], dim=1)
    one = whole.psd[0, :, :sum(n)]
    assert float(((split - one).abs() / one.max()).max()) <= 1e-5
