"""PyTorch port: the materializing frame chain (impl "pallas": K6 range FFT,
K7 peak search), the range-FFT output of the profile chain, and the
recompute export (K5a/K5b, and past nb_pad 272 its bin-blocked pair) vs
the JAX package on the CPU.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do. The
tolerances are those the JAX package applies between its own formulations
(tests/test_pallas_ops.py, tests/test_pallas_chain.py,
tests/test_stft_pallas.py), stated in each test.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmcw_radar_processing_tpu.config import (
    AlgorithmConfig,
    RadarConfig,
    default_device_config,
)
from fmcw_radar_processing_tpu.dsp.stft import StftOperator as JStftOperator
from fmcw_radar_processing_tpu.pipeline.recording import (
    RadarPipeline as JaxPipeline,
)
from fmcw_radar_processing_tpu_torch.dsp.detection import search_peaks
from fmcw_radar_processing_tpu_torch.dsp.fast_time import range_profile
from fmcw_radar_processing_tpu_torch.dsp.slow_time import (
    SlowTimeOperator,
    doppler_at_bins,
)
from fmcw_radar_processing_tpu_torch.dsp.stft import DB_FLOOR, StftOperator
from fmcw_radar_processing_tpu_torch.ops import detect_cuda as dtc
from fmcw_radar_processing_tpu_torch.ops import fast_time_cuda as ftc
from fmcw_radar_processing_tpu_torch.ops import stft_cuda as stc
from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import (
    UNPORTED_IMPLS,
    make_frame_chain,
)
from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline
from fmcw_radar_processing_tpu_torch.utils.cplx import to_pair

from .conftest import make_recording
from .oracle import (
    log_rescale_oracle,
    process_recording_oracle,
    psd_db_oracle,
    spectrogram_oracle,
)
from .test_pipeline import _mixed_recording, _tpu_layout
from .test_torch_ops import (
    OP_KW,
    _k1_inputs,
    _k1_port,
    _signal,
    _snr_db,
    assert_within_one_bf16_ulp,
)

jftp = importlib.import_module("fmcw_radar_processing_tpu.ops.fast_time_pallas")
jdet = importlib.import_module("fmcw_radar_processing_tpu.ops.detect_pallas")
jstp = importlib.import_module("fmcw_radar_processing_tpu.ops.stft_pallas")
jfast = importlib.import_module("fmcw_radar_processing_tpu.dsp.fast_time")
jslow = importlib.import_module("fmcw_radar_processing_tpu.dsp.slow_time")
jchain = importlib.import_module("fmcw_radar_processing_tpu.pipeline.frame_chain")


def _multi_cfg(t=3):
    return RadarConfig.create(default_device_config(),
                              AlgorithmConfig(max_num_targets=t))


def _assert_detection_equal(got, want, exact_magnitude=True):
    """idx and valid, every slot (invalid ones included), exactly; the
    magnitude exactly too, or, where the two profiles were computed apart,
    within the waterfall's rtol 1e-5 / atol 1e-2 (zero on invalid slots)."""
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    if exact_magnitude:
        np.testing.assert_array_equal(got.magnitude.numpy(),
                                      np.asarray(want.magnitude))
    else:
        np.testing.assert_allclose(got.magnitude.numpy(),
                                   np.asarray(want.magnitude), rtol=1e-5,
                                   atol=1e-2)
        assert torch.all(got.magnitude[~got.valid] == 0)


# --- K6 -----------------------------------------------------------------------


@pytest.mark.parametrize("f", [10, 9])  # 9: not a whole group of frames
def test_fast_time_plain_matches_pallas(cfg, rng, f):
    """rf and profile vs fast_time_pallas on the inputs of
    tests/test_pallas_ops.py:22-40, with its bound rtol 1e-5 / atol 1e-2;
    the profile equals K1's plain one."""
    frames, calib = make_recording(cfg, num_frames=f, rng=rng)
    raw = to_pair(np.swapaxes(frames, -1, -2)).reshape(f, cfg.pn, 2 * cfg.nts)
    calib = to_pair(calib)
    w, off, x = _k1_port(cfg, raw, calib)
    rf, prof = ftc.fast_time(x, w, off, cfg.pn)
    assert rf.shape == (f, cfg.pn, cfg.range_fft_size, 2)
    assert prof.shape == (f, cfg.range_fft_size)
    rf_j, prof_j = jftp.fast_time_pallas(jnp.asarray(raw), jnp.asarray(calib),
                                         cfg, interpret=True)
    np.testing.assert_allclose(rf.numpy(), np.asarray(rf_j), rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(prof.numpy(), np.asarray(prof_j), rtol=1e-5,
                               atol=1e-2)
    assert torch.equal(prof, ftc.fast_time_profile_ref(x, w, off, cfg.pn))


def test_k6_weight_is_the_pallas_operands(cfg):
    """The blocked weight, rearranged, is JAX K6's mr / mi bit for bit:
    W[0::2, :K] = mr, W[1::2, :K] = −mi, W[0::2, K:] = mi, W[1::2, K:] = mr."""
    k = cfg.range_fft_size
    m = jfast.build_fast_time_matrix(cfg)
    mr = np.asarray(jnp.asarray(m.real.T.copy(), jnp.float32))
    mi = np.asarray(jnp.asarray(m.imag.T.copy(), jnp.float32))
    w = ftc.blocked_weight(cfg, "cpu").numpy()
    assert w.shape == (2 * cfg.nts, 2 * k) and w.dtype == np.float32
    for got, want in ((w[0::2, :k], mr), (w[1::2, :k], -mi),
                      (w[0::2, k:], mi), (w[1::2, k:], mr)):
        np.testing.assert_array_equal(got, want)


def test_range_profile_matches_jax(cfg, rng):
    rf = rng.standard_normal((5, cfg.pn, cfg.range_fft_size, 2)).astype(np.float32)
    got = range_profile(torch.as_tensor(rf)).numpy()
    want = np.asarray(jfast.range_profile(jnp.asarray(rf)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# --- K7 -----------------------------------------------------------------------


def _recording_profile(cfg, rng, f=12):
    raw, calib = _k1_inputs(cfg, rng, f=f)
    w, off, x = _k1_port(cfg, raw, calib)
    return ftc.fast_time_profile_ref(x, w, off, cfg.pn).numpy()


def test_search_peaks_fused_plain_matches_pallas_recording(cfg, rng):
    """T = 1 on a recording where every third frame has no target: every
    slot exact, invalid ones included; valid slots equal search_peaks'."""
    prof = _recording_profile(cfg, rng)
    got = dtc.search_peaks_fused(torch.as_tensor(prof), cfg)
    want = jdet.search_peaks_pallas(jnp.asarray(prof), cfg, interpret=True)
    _assert_detection_equal(got, want)
    assert got.valid.any() and not got.valid.all()
    xla = search_peaks(torch.as_tensor(prof), cfg)
    v = got.valid
    assert torch.equal(xla.valid, v) and torch.equal(xla.idx[v], got.idx[v])


def _hand_made(case: str, k: int) -> np.ndarray:
    profile = np.zeros((4, k), np.float32)
    if case == "multi":  # tests/test_pallas_ops.py:92-114
        profile[0, 30] = 500.0
        profile[0, 60] = 900.0
        profile[0, 100] = 700.0
        profile[1, 44] = 300.0
    elif case == "plateaus_and_ties":
        profile[0, 40:43] = 600.0  # a plateau: every bin ≥ both neighbours
        profile[0, 80] = 600.0  # ties the plateau: the lowest bin goes first
        profile[1, 50] = 200.0  # at the threshold: not above it
        profile[1, 51] = np.nextafter(np.float32(200.0), np.float32(300.0))
        profile[2, 0] = 900.0  # outside the distance gate
        profile[2, 120] = 250.0
        profile[3] = 400.0  # flat: every gated bin is a peak
    return profile


@pytest.mark.parametrize("case", ["multi", "plateaus_and_ties", "empty"])
def test_search_peaks_fused_plain_matches_pallas_t3(case):
    """T = 3 on hand-made profiles: all of idx, magnitude and valid exact,
    invalid slots included (idx 0 where nothing is left)."""
    cfg = _multi_cfg(3)
    prof = _hand_made(case, cfg.range_fft_size)
    got = dtc.search_peaks_fused(torch.as_tensor(prof), cfg)
    want = jdet.search_peaks_pallas(jnp.asarray(prof), cfg, interpret=True)
    _assert_detection_equal(got, want)
    assert got.idx.shape == (4, 3)
    assert torch.all(got.idx[~got.valid] == 0)
    xla = search_peaks(torch.as_tensor(prof), cfg)
    assert torch.equal(xla.valid, got.valid)
    assert torch.equal(xla.idx[got.valid], got.idx[got.valid])


# --- the materializing chain ----------------------------------------------


def test_doppler_at_bins_matches_jax(cfg, rng):
    """Four float32 einsums on both sides: rtol 1e-5, atol 1e-3."""
    rf = (100 * rng.standard_normal((6, cfg.pn, cfg.range_fft_size, 2))
          ).astype(np.float32)
    idx = rng.integers(0, cfg.range_fft_size, (6, 2)).astype(np.int32)
    got = doppler_at_bins(SlowTimeOperator.create(cfg, "cpu"), torch.as_tensor(rf),
                          torch.as_tensor(idx)).numpy()
    want = np.asarray(jslow.doppler_at_bins(jslow.SlowTimeOperator.create(cfg),
                                            jnp.asarray(rf), jnp.asarray(idx)))
    assert got.shape == (6, 2, cfg.doppler_fft_size, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def _chain_inputs(cfg, rng, f=12):
    frames, calib = _mixed_recording(cfg, rng, f=f)
    raw = to_pair(_tpu_layout(frames)).reshape(f, cfg.pn, 2 * cfg.nts)
    return raw, to_pair(calib)


def _compare_chain_outputs(got, want, range_fft: bool):
    """detected and idx exact; waterfall rtol 1e-5 / atol 1e-2; range exact;
    speed rtol 1e-6 / atol 1e-7. The strongest chirps and the cube come from
    one packed matmul here and four dots in JAX, whose sums cancel
    differently in the weak bins: there the bound is the JAX package's own
    between its packed and four-dot chains, rtol 1e-5 / atol 1e-5·max|rf|
    (tests/test_fused_chain.py:73-90)."""
    np.testing.assert_array_equal(got.detected.numpy(), np.asarray(want.detected))
    assert got.detected.any() and not got.detected.all()
    _assert_detection_equal(got.detection, want.detection,
                            exact_magnitude=False)
    np.testing.assert_allclose(got.waterfall.numpy(), np.asarray(want.waterfall),
                               rtol=1e-5, atol=1e-2)
    np.testing.assert_array_equal(got.range.numpy(), np.asarray(want.range))
    np.testing.assert_allclose(got.speed.numpy(), np.asarray(want.speed),
                               rtol=1e-6, atol=1e-7)
    scale = float(np.abs(np.asarray(want.strongest_chirps)).max())
    np.testing.assert_allclose(got.strongest_chirps.numpy(),
                               np.asarray(want.strongest_chirps),
                               rtol=1e-5, atol=1e-5 * scale)
    if range_fft:
        scale = float(np.abs(np.asarray(want.range_fft)).max())
        np.testing.assert_allclose(got.range_fft.numpy(),
                                   np.asarray(want.range_fft),
                                   rtol=1e-5, atol=1e-5 * scale)
    else:
        assert got.range_fft is None and want.range_fft is None


@pytest.mark.parametrize("return_range_fft", [False, True])
def test_pallas_chain_matches_jax(cfg, rng, return_range_fft):
    raw, calib = _chain_inputs(cfg, rng)
    got = make_frame_chain(cfg, "cpu", return_range_fft=return_range_fft,
                           impl="pallas")(torch.as_tensor(raw),
                                          torch.as_tensor(calib))
    want = jchain.make_frame_chain(cfg, return_range_fft=return_range_fft,
                                   impl="pallas")(jnp.asarray(raw),
                                                  jnp.asarray(calib))
    _compare_chain_outputs(got, want, return_range_fft)


@pytest.mark.parametrize("impl", ["auto", "pallas_profile", "pallas_profile_high"])
def test_profile_chain_return_range_fft_matches_jax(cfg, rng, impl):
    """return_range_fft=True on the profile chain: the JAX package's plain
    branch (PackedFastTime.rf, range_profile, search_peaks), held to JAX
    impl "pallas_profile"; the chain's other outputs are those it gives
    without the cube — to rtol 1e-5 / atol 1e-2 where that is exact float32
    ("auto" and "pallas_profile" on the CPU), above 100 dB where it is
    K1a's bf16x3 ("pallas_profile_high")."""
    raw, calib = _chain_inputs(cfg, rng)
    args = (torch.as_tensor(raw), torch.as_tensor(calib))
    got = make_frame_chain(cfg, "cpu", return_range_fft=True, impl=impl)(*args)
    want = jchain.make_frame_chain(cfg, return_range_fft=True,
                                   impl="pallas_profile")(jnp.asarray(raw),
                                                          jnp.asarray(calib))
    _compare_chain_outputs(got, want, range_fft=True)
    plain = make_frame_chain(cfg, "cpu", impl=impl)(*args)
    assert torch.equal(got.detection.idx, plain.detection.idx)
    if impl == "pallas_profile_high":
        assert _snr_db(plain.waterfall.numpy(), got.waterfall.numpy()) > 100.0
    else:
        np.testing.assert_allclose(got.waterfall.numpy(),
                                   plain.waterfall.numpy(), rtol=1e-5,
                                   atol=1e-2)


@pytest.mark.parametrize("profile", ["fidelity", "production"])
def test_pipeline_impl_pallas_matches_jax(cfg, rng, profile):
    """RadarPipeline(impl="pallas") vs JAX's RadarPipeline(impl="pallas")
    with its Pallas export. Fidelity (float32 stores): intensity atol 2e-2
    (tests/test_pallas_chain.py:10-26) above −120 dB, floors equal; below,
    in deep spectral nulls, the log amplifies the chains' float32 rounding
    (0.07 dB at −211 dB here), as tests/test_stft_pallas.py allows.
    Production stores the intensity and
    dB map in bf16, where two roundings of float32 values that agree to
    1e-3 dB may land one bf16 ulp apart (0.25 dB at −40 dB), so there the
    bound is one bf16 ulp above −120 dB."""
    frames, calib = _mixed_recording(cfg, rng, f=12)
    raw = _tpu_layout(frames)
    dev = default_device_config()
    if profile == "production":
        port_algo = AlgorithmConfig.production()
        jax_algo = AlgorithmConfig.production(stft_impl="pallas")
    else:
        port_algo, jax_algo = AlgorithmConfig(), AlgorithmConfig(stft_impl="pallas")
    got = RadarPipeline(RadarConfig.create(dev, port_algo), device="cpu",
                        impl="pallas").process_recording(raw, calib)
    want = JaxPipeline(RadarConfig.create(dev, jax_algo),
                       impl="pallas").process_recording(raw, calib)
    np.testing.assert_array_equal(got.detected, want.detected)
    np.testing.assert_allclose(got.waterfall, want.waterfall, rtol=1e-5, atol=1e-2)
    np.testing.assert_array_equal(got.target_range, want.target_range)
    np.testing.assert_allclose(got.target_speed, want.target_speed,
                               rtol=1e-6, atol=1e-7)
    a, b = got.spectrogram_intensity, want.spectrogram_intensity
    assert a.shape == b.shape and a.shape[1] > 0
    if profile == "production":
        assert_within_one_bf16_ulp(a, b, b > -120, 1e-3)
    else:
        np.testing.assert_allclose(a[b > -120], b[b > -120], atol=2e-2)
        np.testing.assert_array_equal(a == DB_FLOOR, b == DB_FLOOR)


def test_pipeline_impl_pallas_display_band_vs_oracle(cfg, rng):
    """Production with impl "pallas": ≤ 0.15 dB against the f64 oracle on
    the displayed band (config/radar.py:167-176)."""
    frames, calib = _mixed_recording(cfg, rng)
    pcfg = RadarConfig.create(default_device_config(), AlgorithmConfig.production())
    got = RadarPipeline(pcfg, device="cpu", impl="pallas").process_recording(
        _tpu_layout(frames), calib)
    ref = process_recording_oracle(frames, calib, cfg)
    np.testing.assert_array_equal(got.detected, ref.detected)
    freqs, _, p = spectrogram_oracle(np.abs(ref.slow_time_signal),
                                     1.0 / cfg.derived.prt, nfft=256)
    db = psd_db_oracle(p)
    _, intensity = log_rescale_oracle(freqs, db)
    assert got.spectrogram_intensity.shape == intensity.shape
    band = intensity > -40
    assert band.sum() > 100
    assert np.abs(got.spectrogram_intensity - intensity)[band].max() <= 0.15


@pytest.mark.parametrize("impl", UNPORTED_IMPLS)
def test_unported_impls_raise(cfg, impl):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_frame_chain(cfg, "cpu", impl=impl)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        RadarPipeline(cfg, device="cpu", impl=impl)


def test_unknown_impl_raises_as_in_jax(cfg):
    with pytest.raises(ValueError, match="unknown impl"):
        jchain.make_frame_chain(cfg, impl="pallas_fused")
    with pytest.raises(ValueError, match="unknown impl"):
        make_frame_chain(cfg, "cpu", impl="pallas_fused")


# --- K5a / K5b: the recompute export -----------------------------------------


def _jax_recompute(sig, count, nfft=256, **kw):
    op = JStftOperator.create(**{**OP_KW, "nfft": nfft})
    out = jstp.spectrogram_pallas(jnp.asarray(sig), jnp.asarray(count), op,
                                  tile=512, recompute=True, **kw)
    return out[0], *(np.asarray(a).astype(np.float32) if a.dtype == jnp.bfloat16
                     else np.asarray(a) for a in out[1:])


@pytest.mark.parametrize("l,count", [(4096, 4096), (4096, 1000), (700, 650)])
def test_recompute_matches_pallas_and_materializing(l, count):
    """psd is None; db and intensity bit-equal to the port's materializing
    export, and within tests/test_stft_pallas.py's bounds of JAX's
    recompute pair (dB atol 1e-3 and intensity atol 2e-3 above −120 dB,
    floors equal)."""
    sig = torch.as_tensor(_signal(l, count))
    op = StftOperator.create(**OP_KW)
    p, db, intensity = stc.spectrogram(sig, count, op, recompute=True)
    assert p is None
    _, db_m, int_m = stc.spectrogram(sig, count, op)
    assert torch.equal(db, db_m) and torch.equal(intensity, int_m)
    p_j, db_j, int_j = _jax_recompute(_signal(l, count), count)
    assert p_j is None and db.shape == db_j.shape
    assert intensity.shape == int_j.shape
    m = db_j > -120
    np.testing.assert_allclose(db.numpy()[m], db_j[m], atol=1e-3)
    np.testing.assert_array_equal(db.numpy() == DB_FLOOR, db_j == DB_FLOOR)
    mi = int_j > -120
    np.testing.assert_allclose(intensity.numpy()[mi], int_j[mi], atol=2e-3)
    assert np.all(db.numpy()[:, count - 19:] == DB_FLOOR)


@pytest.mark.parametrize("int_dtype", [torch.bfloat16, torch.int8])
def test_recompute_intensity_dtypes(int_dtype):
    """bf16 and int8 intensity: bit-equal to the materializing export; vs
    JAX's recompute pair within one bf16 ulp or one int8 code."""
    sig = torch.as_tensor(_signal(4096, 1000))
    op = StftOperator.create(**OP_KW)
    _, db, intensity = stc.spectrogram(sig, 1000, op, intensity_dtype=int_dtype,
                                       recompute=True)
    assert db.dtype == torch.float32 and intensity.dtype == int_dtype
    _, db_m, int_m = stc.spectrogram(sig, 1000, op, intensity_dtype=int_dtype)
    assert torch.equal(db, db_m) and torch.equal(intensity, int_m)
    jdtype = jnp.bfloat16 if int_dtype == torch.bfloat16 else jnp.int8
    _, _, int_j = _jax_recompute(_signal(4096, 1000), 1000,
                                 intensity_dtype=jdtype)
    if int_dtype == torch.int8:
        assert np.abs(intensity.numpy().astype(np.int32)
                      - int_j.astype(np.int32)).max() <= 1
    else:
        assert_within_one_bf16_ulp(intensity.float().numpy(), int_j,
                                   int_j > -120, 2e-3)


@pytest.mark.parametrize("nfft", [600, 1000])  # nb_pad 304 and 504
@pytest.mark.parametrize("int_dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_recompute_past_untiled_kernels_matches_pallas(nfft, int_dtype):
    """272 < nb_pad ≤ 512, where the card takes the bin-blocked recompute
    pair: psd None; db and intensity bit-equal to the port's materializing
    export (K4a/K4b's plain versions); vs JAX's recompute pair, the bounds
    of the two tests above (dB atol 1e-3 above −120 dB, floors equal;
    intensity atol 2e-3, one bf16 ulp or one int8 code)."""
    sig = _signal(4096, 3000)
    op = StftOperator.create(**{**OP_KW, "nfft": nfft})
    p, db, intensity = stc.spectrogram(torch.as_tensor(sig), 3000, op,
                                       intensity_dtype=int_dtype, recompute=True)
    assert p is None and db.dtype == torch.float32
    assert intensity.dtype == int_dtype
    _, db_m, int_m = stc.spectrogram(torch.as_tensor(sig), 3000, op,
                                     intensity_dtype=int_dtype)
    assert torch.equal(db, db_m) and torch.equal(intensity, int_m)
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
              torch.int8: jnp.int8}[int_dtype]
    p_j, db_j, int_j = _jax_recompute(sig, 3000, nfft=nfft, intensity_dtype=jdtype)
    assert p_j is None and db.shape == db_j.shape == (op.num_bins, 4077)
    assert intensity.shape == int_j.shape
    db = db.numpy()
    m = db_j > -120
    np.testing.assert_allclose(db[m], db_j[m], atol=1e-3)
    np.testing.assert_array_equal(db == DB_FLOOR, db_j == DB_FLOOR)
    assert np.all(db[:, 3000 - 19:] == DB_FLOOR)
    if int_dtype == torch.int8:
        assert np.abs(intensity.numpy().astype(np.int32)
                      - int_j.astype(np.int32)).max() <= 1
    elif int_dtype == torch.bfloat16:
        assert_within_one_bf16_ulp(intensity.float().numpy(), int_j,
                                   int_j > -120, 2e-3)
    else:
        mi = int_j > -120
        np.testing.assert_allclose(intensity.numpy()[mi], int_j[mi], atol=2e-3)


@pytest.mark.parametrize("case", ["nfft_1024", "bf16_db_store", "hop_2",
                                  "nfft_1022"])
def test_recompute_argument_rules(case):
    """recompute=True raises ValueError past nb_pad 512 (nfft 1,024), for a
    bf16 dB store and for hop ≠ 1 — as spectrogram_pallas does — and runs
    at nb_pad 512 (nfft 1,022), as spectrogram_pallas does."""
    kw = dict(OP_KW)
    if case.startswith("nfft_"):
        kw["nfft"] = int(case[5:])
    elif case == "hop_2":
        kw["hop"] = 2
    sig = _signal(4096, 3000)
    port_extra = {"db_store_dtype": torch.bfloat16} if case == "bf16_db_store" else {}
    extra = {"db_store_dtype": jnp.bfloat16} if case == "bf16_db_store" else {}

    def port():
        return stc.spectrogram(torch.as_tensor(sig), 3000,
                               StftOperator.create(**kw), recompute=True,
                               **port_extra)

    def jax():
        return jstp.spectrogram_pallas(jnp.asarray(sig), jnp.asarray(3000),
                                       JStftOperator.create(**kw), recompute=True,
                                       **extra)

    if case == "nfft_1022":
        assert port()[1].shape == jax()[1].shape == (512, 4077)
        return
    with pytest.raises(ValueError):
        port()
    with pytest.raises(ValueError):
        jax()
