"""PyTorch port: every frame-chain impl of the JAX package, and stft_impl.

The JAX package's ``make_frame_chain`` takes seven impls. Beside the
kernel chains held elsewhere ("pallas_profile", "pallas_profile_high" in
test_torch_ops.py, "pallas" in test_torch_materialize.py), this file holds
the port's plain formulations "fused", "xla" and "fused_bf16", K1c's impl
"pallas_profile_bf16", and the export's ``AlgorithmConfig.stft_impl`` to
the JAX package on the CPU (its Pallas kernels in interpret mode, as its
own tests run them), at the sizes of tests/test_pallas_chain.py.
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
from fmcw_radar_processing_tpu.pipeline.recording import (
    RadarPipeline as JaxPipeline,
)
from fmcw_radar_processing_tpu_torch.dsp.fast_time import (
    FastTimeOperator,
    PackedFastTime,
)
from fmcw_radar_processing_tpu_torch.dsp.stft import resolve_stft_impl
from fmcw_radar_processing_tpu_torch.ops import fast_time_cuda as ftc
from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import (
    IMPLS,
    make_frame_chain,
    resolve_impl,
)
from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline
from fmcw_radar_processing_tpu_torch.utils.cplx import to_pair

from .test_pipeline import _mixed_recording, _tpu_layout
from .test_torch_ops import _k1_inputs, _k1_port, _snr_db

jfast = importlib.import_module("fmcw_radar_processing_tpu.dsp.fast_time")
jchain = importlib.import_module("fmcw_radar_processing_tpu.pipeline.frame_chain")

DB_FLOOR = -1000.0


def _pipelines(cfg, rng, impl):
    """process_recording of one 12-frame recording by the port on the CPU
    and by JAX, both with ``impl``; detections checked equal. Returns
    (port, JAX, (raw, calib))."""
    frames, calib = _mixed_recording(cfg, rng, f=12)
    raw = _tpu_layout(frames)
    got = RadarPipeline(cfg, device="cpu", impl=impl).process_recording(raw, calib)
    want = JaxPipeline(cfg, impl=impl).process_recording(raw, calib)
    np.testing.assert_array_equal(got.detected, want.detected)
    assert got.detected.any() and not got.detected.all()
    return got, want, (raw, calib)


# --- the plain formulations "fused", "xla", "fused_bf16" ----------------------


@pytest.mark.parametrize("impl", ["fused", "xla"])
def test_pipeline_impl_matches_jax(cfg, rng, impl):
    """RadarPipeline(impl) vs the JAX impl of the same name: detections and
    ranges exact, waterfall rtol 1e-5 / atol 1e-2, speed rtol 1e-6 / atol
    1e-7 (tests/test_pallas_chain.py:10-44)."""
    got, want, _ = _pipelines(cfg, rng, impl)
    np.testing.assert_array_equal(got.target_range, want.target_range)
    np.testing.assert_allclose(got.waterfall, want.waterfall, rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(got.target_speed, want.target_speed,
                               rtol=1e-6, atol=1e-7)


def test_pipeline_fused_bf16_matches_jax(cfg, rng):
    """fused_bf16: both sides round the same operands to bf16 and sum in
    float32 (JAX's optimization_barrier keeps its casts on the CPU), so
    detections exact and the waterfall rtol 1e-5 / atol 1e-2; ranges exact,
    and speeds, from the float32 recompute, as for "fused"."""
    got, want, inputs = _pipelines(cfg, rng, "fused_bf16")
    np.testing.assert_allclose(got.waterfall, want.waterfall, rtol=1e-5, atol=1e-2)
    np.testing.assert_array_equal(got.target_range, want.target_range)
    np.testing.assert_allclose(got.target_speed, want.target_speed,
                               rtol=1e-6, atol=1e-7)
    exact = RadarPipeline(cfg, device="cpu", impl="fused").process_recording(
        *inputs)
    # The quantization is real: the bf16 waterfall is not the float32 one.
    assert 30.0 < _snr_db(got.waterfall, exact.waterfall) < 80.0


@pytest.mark.parametrize("impl", ["fused", "xla", "fused_bf16"])
def test_chain_return_range_fft_matches_jax(cfg, rng, impl):
    """make_frame_chain(impl, return_range_fft=True) vs JAX's: detections
    exact; the cube and the strongest chirps within rtol 1e-5 / atol
    1e-5·max|rf| (tests/test_fused_chain.py:73-90); ranges exact."""
    frames, calib = _mixed_recording(cfg, rng, f=12)
    raw = to_pair(_tpu_layout(frames)).reshape(12, cfg.pn, 2 * cfg.nts)
    cal = to_pair(calib)
    got = make_frame_chain(cfg, "cpu", return_range_fft=True, impl=impl)(
        torch.as_tensor(raw), torch.as_tensor(cal))
    want = jchain.make_frame_chain(cfg, return_range_fft=True, impl=impl)(
        jnp.asarray(raw), jnp.asarray(cal))
    np.testing.assert_array_equal(got.detected.numpy(), np.asarray(want.detected))
    np.testing.assert_array_equal(got.detection.idx.numpy(),
                                  np.asarray(want.detection.idx))
    np.testing.assert_array_equal(got.range.numpy(), np.asarray(want.range))
    scale = float(np.abs(np.asarray(want.range_fft)).max())
    for name in ("range_fft", "strongest_chirps"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5 * scale)


def test_fast_time_operator_matches_jax(cfg, rng):
    """FastTimeOperator (four einsums) on pair and flat rows vs JAX's:
    rtol 1e-5 / atol 1e-5·max|rf|; its offset likewise."""
    frames, calib = _mixed_recording(cfg, rng, f=4)
    pair = to_pair(_tpu_layout(frames))  # [F, PN, NTS, 2]
    cal = to_pair(calib)
    op = FastTimeOperator.create(cfg, "cpu")
    want = np.asarray(jfast.FastTimeOperator.create(cfg)(jnp.asarray(pair),
                                                         jnp.asarray(cal)))
    scale = float(np.abs(want).max())
    for x in (pair, pair.reshape(4, cfg.pn, 2 * cfg.nts)):
        got = op(torch.as_tensor(x), torch.as_tensor(cal)).numpy()
        assert got.shape == (4, cfg.pn, cfg.range_fft_size, 2)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_fast_time_dtype_matches_jax(cfg, rng, dtype):
    """PackedFastTime(compute_dtype) rf and profile vs JAX's at the same
    dtype: float32 results at both; rtol 1e-5 / atol 1e-5·max|rf|."""
    frames, calib = _mixed_recording(cfg, rng, f=4)
    raw = to_pair(_tpu_layout(frames)).reshape(4, cfg.pn, 2 * cfg.nts)
    cal = to_pair(calib)
    pft = PackedFastTime.create(cfg, "cpu", getattr(torch, dtype))
    jpft = jfast.PackedFastTime.create(cfg, getattr(jnp, dtype))
    for fn in ("rf", "profile"):
        got = getattr(pft, fn)(torch.as_tensor(raw), torch.as_tensor(cal))
        want = np.asarray(getattr(jpft, fn)(jnp.asarray(raw), jnp.asarray(cal)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
    f32 = PackedFastTime.create(cfg, "cpu").rf(torch.as_tensor(raw),
                                               torch.as_tensor(cal))
    got = pft.rf(torch.as_tensor(raw), torch.as_tensor(cal))
    assert torch.equal(got, f32) == (dtype == "float32")


# --- K1c, impl "pallas_profile_bf16" -----------------------------------------


def test_pipeline_pallas_profile_bf16_matches_jax(cfg, rng):
    """RadarPipeline(impl="pallas_profile_bf16") (K1c's plain version) vs
    JAX's, whose interpret mode runs Precision.DEFAULT as exact float32 on
    the CPU: detections and ranges exact, speed rtol 1e-5 / atol 1e-6 (the
    float32 recompute on both sides), waterfall above 30 dB
    (tests/test_pallas_chain.py:68-86)."""
    got, want, _ = _pipelines(cfg, rng, "pallas_profile_bf16")
    np.testing.assert_array_equal(got.target_range, want.target_range)
    np.testing.assert_allclose(got.target_speed, want.target_speed,
                               rtol=1e-5, atol=1e-6)
    assert _snr_db(got.waterfall, want.waterfall) > 30.0


def test_pallas_profile_bf16_chain_runs_k1c(cfg, rng, monkeypatch):
    """The chain's profile is K1c's wrapper (no other profile wrapper
    called); with return_range_fft the exact PackedFastTime.rf instead."""
    raw, calib = _k1_inputs(cfg, rng)
    args = (torch.as_tensor(raw), torch.as_tensor(calib))
    called = []
    chain_mod = importlib.import_module(
        "fmcw_radar_processing_tpu_torch.pipeline.frame_chain")
    for name in ("fast_time_profile", "fast_time_profile_b3",
                 "fast_time_profile_bf16", "fast_time"):
        real = getattr(chain_mod, name)
        monkeypatch.setattr(chain_mod, name,
                            lambda *a, _n=name, _f=real: called.append(_n) or _f(*a))
    out = make_frame_chain(cfg, "cpu", impl="pallas_profile_bf16")(*args)
    assert called == ["fast_time_profile_bf16"] and out.range_fft is None
    w, off, x = _k1_port(cfg, raw, calib)
    want = ftc.fast_time_profile_bf16_ref(x, ftc.split_bf16x3(w)[0], off, cfg.pn)
    assert torch.equal(out.waterfall, want)
    full = make_frame_chain(cfg, "cpu", return_range_fft=True,
                            impl="pallas_profile_bf16")(*args)
    assert called == ["fast_time_profile_bf16"]
    exact = PackedFastTime.create(cfg, "cpu").rf(*args)
    assert torch.equal(full.range_fft, exact)


@pytest.mark.parametrize("seed", [0, 1])
def test_k1c_plain_matches_f64_of_bf16_operands(cfg, seed):
    """fast_time_profile_bf16_ref vs a float64 NumPy product of the same
    bf16-rounded x and w_hi (the offset as given): rtol 1e-5."""
    raw, calib = _k1_inputs(cfg, np.random.default_rng(seed))
    w, off, x = _k1_port(cfg, raw, calib)
    w_hi = ftc.split_bf16x3(w)[0]
    got = ftc.fast_time_profile_bf16(x, w_hi, off, cfg.pn).numpy()
    assert got.shape == (raw.shape[0], cfg.range_fft_size)
    xb = x.to(torch.bfloat16).to(torch.float64).numpy()
    y = xb @ w_hi.to(torch.float64).numpy() - off.numpy().astype(np.float64)
    k = cfg.range_fft_size
    want = np.sqrt(y[:, :k] ** 2 + y[:, k:] ** 2).reshape(-1, cfg.pn, k).max(1)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_k1c_plain_snr_vs_exact(cfg):
    """One bf16 pass against the exact float32 profile: between 40 and 80
    dB (JAX records 55 dB for this class on the TPU), well below K1a's
    bf16x3 (above 100 dB)."""
    raw, calib = _k1_inputs(cfg, np.random.default_rng(2), f=24)
    w, off, x = _k1_port(cfg, raw, calib)
    got = ftc.fast_time_profile_bf16(x, ftc.split_bf16x3(w)[0], off, cfg.pn)
    exact = ftc.fast_time_profile(x, w, off, cfg.pn)
    assert 40.0 < _snr_db(got.numpy(), exact.numpy()) < 80.0


# --- impl names ---------------------------------------------------------------


def test_impls_are_the_jax_impls(cfg):
    """The port takes every name the JAX chain takes, and the chain on the
    CPU builds for each (no NotImplementedError)."""
    assert set(IMPLS) == {"fused", "xla", "pallas", "pallas_profile",
                          "pallas_profile_high", "pallas_profile_bf16",
                          "fused_bf16"}
    for impl in ("auto", *IMPLS):
        jchain.make_frame_chain(cfg, impl=impl)
        assert resolve_impl(impl, "cpu") in IMPLS
        assert callable(make_frame_chain(cfg, "cpu", impl=impl))


@pytest.mark.parametrize("impl", ["pallas_profile_b3", "bf16", "XLA"])
def test_unknown_impl_raises_value_error(cfg, impl):
    with pytest.raises(ValueError, match="unknown impl"):
        jchain.make_frame_chain(cfg, impl=impl)
    with pytest.raises(ValueError, match="unknown impl"):
        make_frame_chain(cfg, "cpu", impl=impl)
    with pytest.raises(ValueError, match="unknown impl"):
        RadarPipeline(cfg, device="cpu", impl=impl)


# --- stft_impl ------------------------------------------------------------------


@pytest.mark.parametrize("impl,hop,want", [
    ("auto", 1, "pallas"), ("auto", 4, "xla"), ("pallas", 1, "pallas"),
    ("xla", 1, "xla"), ("xla", 3, "xla"), ("other", 1, "xla"),
])
def test_resolve_stft_impl(impl, hop, want):
    """"auto" is the kernels at hop 1 on either device; "pallas" the
    kernels; anything else the plain composition, as JAX's _stft_stage
    takes its XLA branch for anything but "pallas"."""
    assert resolve_stft_impl(impl, hop) == want


def test_stft_impl_xla_matches_jax(cfg, rng):
    """production(stft_impl="xla"): the port's dB map is JAX's float32 one
    (not the kernels' bf16 store): within 1e-3 dB on the displayed band
    (above −40 dB), 0.2 dB down to −120 dB where the log amplifies the two
    sides' float32 rounding (1e-5 relative: 1.2e-3 dB at −100 dB here), floors
    equal (tests/test_torch_pipeline.py:152-158); intensity (bf16 on both
    sides, rounded from float32 values that agree to 2e-3 dB) within 2e-3
    dB or one bf16 ulp above −120 dB."""
    from .test_torch_ops import assert_within_one_bf16_ulp

    frames, calib = _mixed_recording(cfg, rng, f=12)
    raw = _tpu_layout(frames)
    pcfg = RadarConfig.create(default_device_config(),
                              AlgorithmConfig.production(stft_impl="xla"))
    got = RadarPipeline(pcfg, device="cpu").process_recording(raw, calib)
    want = JaxPipeline(pcfg).process_recording(raw, calib)
    np.testing.assert_array_equal(got.detected, want.detected)
    a, b = got.spectrogram_psd_db, want.spectrogram_psd_db
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    band, m = b > -40, b > -120
    np.testing.assert_allclose(a[band], b[band], atol=1e-3)
    np.testing.assert_allclose(a[m], b[m], atol=0.2)
    np.testing.assert_array_equal(a == DB_FLOOR, b == DB_FLOOR)
    # The kernel export stores the dB map in bf16 under production: the
    # "xla" map is not that one.
    kern = RadarPipeline(RadarConfig.create(default_device_config(),
                                            AlgorithmConfig.production()),
                         device="cpu").process_recording(raw, calib)
    assert np.abs(kern.spectrogram_psd_db - a)[band].max() > 1e-2
    ai, bi = got.spectrogram_intensity, want.spectrogram_intensity
    assert ai.shape == bi.shape and ai.shape[1] > 0
    assert_within_one_bf16_ulp(ai, bi, bi > -120, 2e-3)


def test_stft_impl_pallas_rejects_hop_4(cfg, rng):
    """stft_impl="pallas" at stft_hop=4: ValueError on both sides, as the
    fused export rejects hop ≠ 1 (ops/stft_pallas.py:383-384)."""
    frames, calib = _mixed_recording(cfg, rng, f=12)
    raw = _tpu_layout(frames)
    hcfg = RadarConfig.create(default_device_config(),
                              AlgorithmConfig.production(stft_impl="pallas",
                                                         stft_hop=4))
    with pytest.raises(ValueError, match="hop"):
        JaxPipeline(hcfg).process_recording(raw, calib)
    with pytest.raises(ValueError, match="hop"):
        RadarPipeline(hcfg, device="cpu").process_recording(raw, calib)
