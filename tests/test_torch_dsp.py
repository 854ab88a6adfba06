"""PyTorch port: host operator builders and plain tensor ops vs the JAX package.

Every NumPy builder of the port must equal its JAX counterpart bit for bit
when fed the same RadarConfig; detection must pick the same bins,
including the lower bin on ties.
"""

import dataclasses
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
from fmcw_radar_processing_tpu.dsp import detection as jdet
from fmcw_radar_processing_tpu.dsp import fast_time as jft
from fmcw_radar_processing_tpu.dsp import slow_time as jst
from fmcw_radar_processing_tpu.dsp import stft as jstft
from fmcw_radar_processing_tpu.dsp import windows as jwin
from fmcw_radar_processing_tpu.utils import cplx as jcplx
from fmcw_radar_processing_tpu_torch.dsp import detection as tdet
from fmcw_radar_processing_tpu_torch.dsp import fast_time as tft
from fmcw_radar_processing_tpu_torch.dsp import slow_time as tst
from fmcw_radar_processing_tpu_torch.dsp import stft as tstft
from fmcw_radar_processing_tpu_torch.dsp import windows as twin
from fmcw_radar_processing_tpu_torch.ops import fast_time_cuda as tftc
from fmcw_radar_processing_tpu_torch.ops import stft_cuda as tstc
from fmcw_radar_processing_tpu_torch.utils import cplx as tcplx


# The JAX package's ops/__init__ re-exports functions under the module
# names, so the kernel modules are taken from the import system directly.
jftp = importlib.import_module("fmcw_radar_processing_tpu.ops.fast_time_pallas")
jstp = importlib.import_module("fmcw_radar_processing_tpu.ops.stft_pallas")


def _cfg(**algo) -> RadarConfig:
    return RadarConfig.create(default_device_config(), AlgorithmConfig(**algo))


# --- (a) operator builders, bit-equal ------------------------------------


@pytest.mark.parametrize("n", [1, 16, 20, 33, 64])
def test_windows_bit_equal(n):
    np.testing.assert_array_equal(twin.blackman(n), jwin.blackman(n))
    np.testing.assert_array_equal(twin.chebwin(n), jwin.chebwin(n))
    np.testing.assert_array_equal(twin.kaiser(n, 3.0), jwin.kaiser(n, 3.0))


@pytest.mark.parametrize("algo", [{}, {"range_fft_size": 128},
                                  {"doppler_fft_size": 8}])
def test_fast_and_slow_time_builders_bit_equal(algo):
    cfg = _cfg(**algo)
    m = tft.build_fast_time_matrix(cfg)
    np.testing.assert_array_equal(m, jft.build_fast_time_matrix(cfg))
    np.testing.assert_array_equal(tft.PackedFastTime.create(cfg, "cpu").w,
                                  jft.PackedFastTime.create(cfg).w)
    np.testing.assert_array_equal(tftc._packed_blocked_weight(m),
                                  jftp._packed_blocked_weight(m))
    np.testing.assert_array_equal(tst.build_slow_time_matrix(cfg),
                                  jst.build_slow_time_matrix(cfg))
    op_t, op_j = tst.SlowTimeOperator.create(cfg, "cpu"), jst.SlowTimeOperator.create(cfg)
    np.testing.assert_array_equal(op_t.m_re, op_j.m_re)
    np.testing.assert_array_equal(op_t.m_im, op_j.m_im)


@pytest.mark.parametrize("algo", [{}, {"min_distance": 2.0, "max_distance": 9.0}])
def test_gate_mask_bit_equal(algo):
    cfg = _cfg(**algo)
    np.testing.assert_array_equal(tdet.gate_mask(cfg),
                                  np.asarray(jdet.gate_mask(cfg)))


@pytest.mark.parametrize("nfft", [32, 256, 512, 2048])
def test_stft_builders_bit_equal(nfft):
    kw = dict(window_length=20, beta=3.0, nfft=nfft, fs=1250.0, hop=1)
    op_t, op_j = tstft.StftOperator.create(**kw), jstft.StftOperator.create(**kw)
    np.testing.assert_array_equal(op_t.a_re, op_j.a_re)
    np.testing.assert_array_equal(op_t.a_im, op_j.a_im)
    assert op_t.scale == op_j.scale
    for align in (8, 16):
        np.testing.assert_array_equal(tstc._folded_operator(op_t, align),
                                      jstp._folded_operator(op_j, align))
    nb = op_t.num_bins
    np.testing.assert_array_equal(tstft._log_interp_matrix(nb, 1024),
                                  jstft._log_interp_matrix(nb, 1024))
    freqs = np.arange(nb, dtype=np.float32) * np.float32(1250.0 / nfft)
    np.testing.assert_array_equal(tstft.log_bins_axis(freqs),
                                  np.asarray(jstft.log_bins_axis(jnp.asarray(freqs))))


@pytest.mark.parametrize("nb", [17, 129, 257])
def test_log_interp_gather_tables_match_dense_matrix(nb):
    """K3's gather-and-lerp tables hold exactly the two nonzeros per row of
    the dense interpolation matrix."""
    i0, w0, w1 = tstc._log_interp_gather(nb, 1024)
    w = jstft._log_interp_matrix(nb, 1024)
    rebuilt = np.zeros_like(w)
    rows = np.arange(1024)
    rebuilt[rows, i0] = w0
    rebuilt[rows, i0 + 1] += w1
    np.testing.assert_array_equal(rebuilt, w)
    assert i0.min() >= 0 and i0.max() <= nb - 2


def test_to_pair_matches_jax():
    rng = np.random.default_rng(0)
    z = (rng.standard_normal((3, 4)) + 1j * rng.standard_normal((3, 4))
         ).astype(np.complex64)
    np.testing.assert_array_equal(tcplx.to_pair(z), jcplx.to_pair(z))
    r = rng.standard_normal(5).astype(np.float32)
    np.testing.assert_array_equal(tcplx.to_pair(r), jcplx.to_pair(r))


def test_int8_codes_match_jax():
    db = np.linspace(-45.0, 2.0, 4001, dtype=np.float32)
    np.testing.assert_array_equal(
        tstft.quantize_db_int8(torch.as_tensor(db)).numpy(),
        np.asarray(jstft.quantize_db_int8(jnp.asarray(db))))
    codes = np.arange(-128, 128, dtype=np.int8)
    np.testing.assert_array_equal(tstft.decode_db_int8(codes),
                                  jstft.decode_db_int8(codes))


# --- (d) detection -------------------------------------------------------


def _profile_with_ties(rng, f, k):
    prof = rng.uniform(0.0, 150.0, (f, k)).astype(np.float32)
    # Equal-height peaks: frame 0 has two separated equal maxima; frame 1 a
    # plateau (neighbours equal, both count as local maxima).
    prof[0, 40] = prof[0, 90] = 900.0
    prof[1, 60] = prof[1, 61] = 700.0
    prof[2, 70] = 800.0
    prof[2, 30] = prof[2, 100] = 500.0
    prof[3] = 10.0  # below threshold: no detection
    return prof


@pytest.mark.parametrize("t", [1, 2, 3])
def test_search_peaks_matches_jax(t):
    cfg = _cfg(max_num_targets=t)
    rng = np.random.default_rng(11)
    prof = _profile_with_ties(rng, 16, cfg.range_fft_size)
    got = tdet.search_peaks(torch.as_tensor(prof), cfg)
    want = jdet.search_peaks(jnp.asarray(prof), cfg)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.magnitude.numpy(),
                                  np.asarray(want.magnitude))
    # Ties resolve to the lower bin.
    assert got.idx[0, 0] == 40 and got.idx[1, 0] == 60
    if t == 3:
        assert got.idx[2].tolist() == [70, 30, 100]


def test_doppler_and_measurements_match_jax():
    cfg = _cfg(max_num_targets=2)
    rng = np.random.default_rng(4)
    f, t, d = 10, 2, cfg.doppler_fft_size
    rd = rng.standard_normal((f, t, d, 2)).astype(np.float32) * 40.0
    rd[:, :, cfg.zero_doppler_bin] *= 3.0
    rd[0, 0, 3] = 500.0
    got = tst.doppler_peaks_at(torch.as_tensor(rd), cfg)
    want = jst.doppler_peaks_at(jnp.asarray(rd), cfg)
    np.testing.assert_array_equal(got.doppler_idx.numpy(),
                                  np.asarray(want.doppler_idx))
    np.testing.assert_array_equal(got.speed.numpy(), np.asarray(want.speed))
    prof = _profile_with_ties(rng, f, cfg.range_fft_size)
    det_t = tdet.search_peaks(torch.as_tensor(prof), cfg)
    det_j = jdet.search_peaks(jnp.asarray(prof), cfg)
    mt = tst.measurements(det_t, got, cfg)
    mj = jst.measurements(det_j, want, cfg)
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_packed_fast_time_matches_jax():
    """Same operator, f32 sums in another order: the tolerance of the JAX
    package's own impl-vs-impl test (tests/test_pallas_chain.py:41)."""
    cfg = _cfg()
    rng = np.random.default_rng(2)
    raw = rng.standard_normal((3, cfg.pn, 2 * cfg.nts)).astype(np.float32)
    calib = rng.standard_normal((cfg.nts, 2)).astype(np.float32)
    idx = rng.integers(0, cfg.range_fft_size, (3, 2)).astype(np.int32)
    pt, pj = tft.PackedFastTime.create(cfg, "cpu"), jft.PackedFastTime.create(cfg)
    r_t, c_t = torch.as_tensor(raw), torch.as_tensor(calib)
    np.testing.assert_allclose(pt.rf(r_t, c_t).numpy(),
                               np.asarray(pj.rf(jnp.asarray(raw), jnp.asarray(calib))),
                               rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(pt.profile(r_t, c_t).numpy(),
                               np.asarray(pj.profile(jnp.asarray(raw), jnp.asarray(calib))),
                               rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(
        pt.rf_at_bins(r_t, c_t, torch.as_tensor(idx)).numpy(),
        np.asarray(pj.rf_at_bins(jnp.asarray(raw), jnp.asarray(calib),
                                 jnp.asarray(idx))),
        rtol=1e-5, atol=1e-2)


def test_psd_db_and_log_rescale_match_jax():
    """The plain dB and interpolation ops against the JAX package's XLA
    composition (psd_db + log_frequency_rescale at "highest")."""
    rng = np.random.default_rng(8)
    p = np.abs(rng.standard_normal((129, 300))).astype(np.float32) ** 4
    p[:, 250:] = 0.0
    freqs = np.arange(129, dtype=np.float32) * np.float32(1250.0 / 256)
    res = jstft.SpectrogramResult(power=jnp.asarray(p), frame_valid=None,
                                  freqs=jnp.asarray(freqs), times=None)
    db_j = np.array(jstft.psd_db(res))
    db_t = tstft.psd_db(torch.as_tensor(p)).numpy()
    np.testing.assert_array_equal(db_t == tstft.DB_FLOOR, db_j == jstft.DB_FLOOR)
    np.testing.assert_allclose(db_t, db_j, atol=1e-3)
    lb_j, int_j = jstft.log_frequency_rescale(jnp.asarray(freqs), jnp.asarray(db_j),
                                              1024, precision="highest")
    lb_t, int_t = tstft.log_frequency_rescale(freqs, torch.as_tensor(db_j), 1024)
    np.testing.assert_array_equal(lb_t, np.asarray(lb_j))
    np.testing.assert_allclose(int_t.numpy(), np.asarray(int_j), rtol=1e-6,
                               atol=1e-3)


def test_frame_signal_matches_jax():
    op_kw = dict(window_length=20, beta=3.0, nfft=64, fs=100.0, hop=1)
    x = np.arange(50, dtype=np.float32)
    got = tstft.StftOperator.create(**op_kw).frame_signal(torch.as_tensor(x))
    want = jstft.StftOperator.create(**op_kw).frame_signal(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tstft.stft_frame_count(50, 20, 1) == jstft.stft_frame_count(50, 20, 1)


def test_algorithm_configs_are_shared():
    """The port reads the JAX package's jax-free config objects as-is."""
    prod = AlgorithmConfig.production()
    assert dataclasses.replace(prod) == prod
    assert prod.stft_nfft == 256 and prod.intensity_dtype == "bfloat16"
