"""PyTorch port: STFT hops other than 1 through ``RadarPipeline`` vs the
JAX package on the CPU.

For ``stft_hop ≠ 1`` the JAX pipeline takes its XLA branch on every backend
(``resolve_stft_impl``): the operator product, a float32 dB map, the log
rescale, then the intensity cast. The port runs the same composition in
plain PyTorch. Tolerances are those of tests/test_torch_pipeline.py.
"""

import numpy as np
import pytest

from fmcw_radar_processing_tpu.config import (
    AlgorithmConfig,
    RadarConfig,
    default_device_config,
)
from fmcw_radar_processing_tpu.pipeline.recording import (
    RadarPipeline as JaxPipeline,
)
from fmcw_radar_processing_tpu_torch.dsp.stft import int8_db_step
from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline

from .oracle import (
    log_rescale_oracle,
    process_recording_oracle,
    psd_db_oracle,
    spectrogram_oracle,
)
from .test_pipeline import _mixed_recording, _tpu_layout
from .test_torch_fidelity import assert_intensity_close
from .test_torch_ops import _snr_db
from .test_torch_pipeline import _num

DB_FLOOR = -1000.0

# name: (algorithm settings, intensity class)
CASES = {
    "nfft256_hop4": (dict(stft_nfft=256, stft_hop=4), "float32"),
    "production_hop4": (dict(production=True, stft_hop=4), "bfloat16"),
    "int8_hop2": (dict(stft_nfft=256, stft_hop=2, intensity_dtype="int8"), "int8"),
    "fidelity_hop2": (dict(stft_hop=2), "float32"),
    "gather_hop3": (dict(stft_nfft=512, stft_hop=3, rescale_method="gather"),
                    "float32"),
}


def _algo(settings: dict) -> AlgorithmConfig:
    settings = dict(settings)
    if settings.pop("production", False):
        return AlgorithmConfig.production(**settings)
    return AlgorithmConfig(**settings)


def _pipelines(settings: dict):
    algo = _algo(settings)
    dev = default_device_config()
    return (RadarPipeline(RadarConfig.create(dev, algo), device="cpu"),
            JaxPipeline(RadarConfig.create(dev, algo)))


def _assert_intensity(a, b, kind: str) -> None:
    if kind == "int8":  # decoded codes: equal, or one code apart
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= int8_db_step() * 1.001
        assert (a == b).mean() > 0.999
    else:
        assert_intensity_close(a, b, "production" if kind == "bfloat16"
                               else "fidelity")


def _assert_payloads_close(got: dict, want: dict, kind: str) -> None:
    """The four payloads key by key, as test_service_payloads_match_jax
    compares the service's files."""
    assert got.keys() == want.keys()
    for fname in got:
        a, b = got[fname], want[fname]
        assert a.keys() == b.keys(), fname
        for key in a:
            if isinstance(b[key], (str, int)) or b[key] is None:
                assert a[key] == b[key], (fname, key)
                continue
            assert np.shape(a[key]) == np.shape(b[key]), (fname, key)
            va, vb = _num(a[key]), _num(b[key])
            np.testing.assert_array_equal(np.isnan(va), np.isnan(vb))
            va, vb = va[~np.isnan(va)], vb[~np.isnan(vb)]
            if key == "intensity":
                _assert_intensity(va, vb, kind)
            elif key in ("range_tx1rx1_max_abs", "magnitude"):
                np.testing.assert_allclose(va, vb, rtol=1e-5, atol=1e-2)
            elif key == "speed":
                np.testing.assert_allclose(va, vb, rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_allclose(va, vb, rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("case", list(CASES))
def test_hop_recording_matches_jax(cfg, rng, case):
    """process_recording at hop 2, 3 or 4: detections exact; times, axes and
    shapes equal (rtol 1e-6); the dB map 1e-3 dB in the display band and
    0.2 dB down to −120 dB; the intensity by its dtype; the payloads."""
    settings, kind = CASES[case]
    frames, calib = _mixed_recording(cfg, rng, f=40)
    raw = _tpu_layout(frames)
    port, jax_pipe = _pipelines(settings)
    got = port.process_recording(raw, calib)
    want = jax_pipe.process_recording(raw, calib)
    np.testing.assert_array_equal(got.detected, want.detected)
    assert got.detected.any() and not got.detected.all()
    np.testing.assert_array_equal(got.target_range, want.target_range)
    np.testing.assert_allclose(got.target_speed, want.target_speed,
                               rtol=1e-5, atol=1e-6)
    assert _snr_db(got.waterfall, want.waterfall) > 80.0
    hop = settings["stft_hop"]
    count = int(got.detected.sum()) * cfg.pn
    n_cols = (count - 20) // hop + 1
    assert got.spectrogram_times.shape == want.spectrogram_times.shape == (n_cols,)
    for name in ("spectrogram_times", "spectrogram_freqs",
                 "spectrogram_linear_freqs"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
    a, b = got.spectrogram_psd_db, want.spectrogram_psd_db
    assert a.shape == b.shape and a.dtype == np.float32
    band = b > -40
    assert band.sum() > 100
    np.testing.assert_allclose(a[band], b[band], atol=1e-3)
    deep = b > -120
    np.testing.assert_allclose(a[deep], b[deep], atol=0.2)
    np.testing.assert_array_equal(a == DB_FLOOR, b == DB_FLOOR)
    assert got.spectrogram_intensity.shape == (1024, n_cols)
    _assert_intensity(got.spectrogram_intensity, want.spectrogram_intensity, kind)
    _assert_payloads_close(got.payloads, want.payloads, kind)


def test_hop4_display_band_vs_oracle(cfg, rng):
    """hop 4 against the f64 oracle's spectrogram(hop=4): the dB map and the
    intensity within 0.15 dB on the displayed band (above −40 dB), or above
    100 dB SNR (the contract of config/radar.py:167-176); times rtol 1e-6."""
    frames, calib = _mixed_recording(cfg, rng, f=40)
    port = RadarPipeline(RadarConfig.create(
        default_device_config(), AlgorithmConfig(stft_nfft=256, stft_hop=4)),
        device="cpu")
    got = port.process_recording(_tpu_layout(frames), calib)
    ref = process_recording_oracle(frames, calib, cfg)
    freqs, times, p = spectrogram_oracle(np.abs(ref.slow_time_signal),
                                         1.0 / cfg.derived.prt, hop=4, nfft=256)
    db = psd_db_oracle(p)
    _, intensity = log_rescale_oracle(freqs, db)
    np.testing.assert_allclose(got.spectrogram_times, times, rtol=1e-6)
    for ours, theirs in ((got.spectrogram_psd_db, db),
                         (got.spectrogram_intensity, intensity)):
        assert ours.shape == theirs.shape
        band = theirs > -40
        assert band.sum() > 100
        assert (np.abs(ours - theirs)[band].max() <= 0.15
                or _snr_db(ours, theirs) >= 100.0)


def test_hop4_activity_matches_jax(cfg, rng):
    """Activity mode ("yes") under production(stft_hop=4): the same batches,
    frame ranges, filenames and times; intensity within one bf16 ulp."""
    frames, calib = _mixed_recording(cfg, rng, f=250)
    raw = _tpu_layout(frames)
    port, jax_pipe = _pipelines(dict(production=True, stft_hop=4))
    got = port.process_activity(raw, calib)
    want = jax_pipe.process_activity(raw, calib)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert (g.batch, g.start_frame, g.end_frame, g.filename) == (
            w.batch, w.start_frame, w.end_frame, w.filename)
        assert g.payload.keys() == w.payload.keys()
        for key in g.payload:
            if key in ("time", "frequency"):
                np.testing.assert_allclose(g.payload[key], w.payload[key],
                                           rtol=1e-6)
            elif key == "intensity":
                assert_intensity_close(g.payload[key], w.payload[key],
                                       "production")
            else:
                assert g.payload[key] == w.payload[key], key


def test_hop1_outputs_unchanged(cfg, rng):
    """stft_hop=1 written out is the default hop: the kernel path, with the
    same arrays bit for bit."""
    frames, calib = _mixed_recording(cfg, rng, f=24)
    raw = _tpu_layout(frames)
    dev = default_device_config()
    outs = [RadarPipeline(RadarConfig.create(dev, AlgorithmConfig.production(
                stft_hop=h)), device="cpu").process_recording(raw, calib)
            for h in (None, 1)]
    for name in ("spectrogram_times", "spectrogram_intensity",
                 "spectrogram_psd_db"):
        np.testing.assert_array_equal(getattr(outs[0], name),
                                      getattr(outs[1], name))
