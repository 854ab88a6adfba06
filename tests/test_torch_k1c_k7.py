"""PyTorch port: what K1c (the one-pass profile) and K7 (the peak search)
compute around their CUDA kernels, held to the JAX package on the CPU.

- K7's launch arguments, made once per (config, device): its gate is
  JAX's ``dsp/detection.py::gate_mask`` and its threshold the float32 one
  (hypothesis over the gate's distances, K 128-1024, the empty gate
  included).
- K1c's launch geometry (``fast_time_cuda.k1c_geometry``) gives every
  (64-row tile, bin) of the profile to exactly one block.
- Their plain versions against JAX's Pallas kernels in interpret mode at
  K 128-1024: ``fast_time_profile_pallas(precision="default")`` and
  ``search_peaks_pallas`` on rows with plateaus, ties, threshold-equal
  values and gate edges.

The tests marked ``cuda`` hold both kernels to their plain versions at the
same widths and skip without a card.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fmcw_radar_processing_tpu.config import (
    AlgorithmConfig,
    RadarConfig,
    default_device_config,
)
from fmcw_radar_processing_tpu_torch import config as tconfig
from fmcw_radar_processing_tpu_torch.ops import _lib
from fmcw_radar_processing_tpu_torch.ops import detect_cuda as dtc
from fmcw_radar_processing_tpu_torch.ops import fast_time_cuda as ftc

from .test_torch_ops import _k1_inputs, _k1_port, _snr_db

jftp = importlib.import_module("fmcw_radar_processing_tpu.ops.fast_time_pallas")
jdet = importlib.import_module("fmcw_radar_processing_tpu.ops.detect_pallas")
jdetection = importlib.import_module("fmcw_radar_processing_tpu.dsp.detection")

R_MAX = 48.0  # the default device's range (dist_per_bin = R_MAX / K)


def _configs(k: int, **alg):
    """The same configuration as (JAX RadarConfig, port RadarConfig)."""
    return (RadarConfig.create(default_device_config(),
                               AlgorithmConfig(range_fft_size=k, **alg)),
            tconfig.RadarConfig.create(tconfig.default_device_config(),
                                       tconfig.AlgorithmConfig(range_fft_size=k,
                                                               **alg)))


# --- K7's launch arguments ---------------------------------------------------


def _distance(k: int):
    """Any float32 distance, or one exactly on a bin's distance (the gate's
    edges). Subnormal float32 values are left out: XLA's CPU flushes them to
    zero in JAX's comparison, NumPy does not."""
    return st.one_of(st.floats(-5.0, 60.0, width=32, allow_subnormal=False),
                     st.integers(-1, k + 1).map(lambda i: i * (R_MAX / k)))


def _gate_run(tcfg) -> tuple[int, int]:
    """The first and last bin of the port's distance gate."""
    bins = np.flatnonzero(dtc._launch_args(tcfg, torch.device("cpu"))[0].numpy())
    return int(bins[0]), int(bins[-1])


@pytest.mark.parametrize("k", [128, 256, 512, 1024])
@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_k7_launch_args_are_the_configs(k, data):
    """The gate K7 reads is JAX's gate_mask (1 inside, 0 outside, all 0
    when min is above max or above the range), the threshold its float32
    value, T the config's; the same objects on a second call and for an
    equal config."""
    lo_m = data.draw(_distance(k), label="min_distance")
    hi_m = data.draw(_distance(k), label="max_distance")
    targets = data.draw(st.integers(1, 4), label="max_num_targets")
    jcfg, tcfg = _configs(k, min_distance=lo_m, max_distance=hi_m,
                          max_num_targets=targets, range_threshold=hi_m + 0.1)
    gate, threshold, t = dtc._launch_args(tcfg, torch.device("cpu"))
    want = np.asarray(jdetection.gate_mask(jcfg))
    assert gate.dtype == torch.float32
    np.testing.assert_array_equal(gate.numpy(), want.astype(np.float32))
    assert threshold == float(np.float32(hi_m + 0.1)) and t == targets
    assert dtc._launch_args(tcfg, torch.device("cpu"))[0] is gate
    # An equal config that is another object: the same cached arguments.
    _, again = _configs(k, min_distance=lo_m, max_distance=hi_m,
                        max_num_targets=targets, range_threshold=hi_m + 0.1)
    assert again is not tcfg
    assert dtc._launch_args(again, torch.device("cpu"))[0] is gate


def test_k7_gate_of_the_default_config():
    """The production config's gate 0.9-25 m at 0.1875 m a bin: bins 5-133."""
    _, tcfg = _configs(256)
    assert _gate_run(tcfg) == (5, 133)


# --- K1c's launch geometry ----------------------------------------------------


@pytest.mark.parametrize("f", [0, 1, 9, 12, 1000])
@pytest.mark.parametrize("k", [64, 128, 256, 320, 512])
def test_k1c_geometry_covers_each_tile_and_bin_once(k, f):
    """Block (b, g) of a launch (bin0, group_bins, groups, blocks) owns the
    bins from bin0 + g·group_bins and the row tiles b, b + blocks, ...:
    over the launches, every (tile, bin) of the profile exactly once, in
    groups of at most 256 bins in 64-bin slices. The launches run one after
    the other, so each may have the whole card: no more blocks than SMs or
    tiles in each, and all of them where there are as many tiles."""
    rows = 16 * f
    tiles = -(-rows // ftc.K1C_ROW_TILE)
    for sms in (132, 3):
        launches = ftc.k1c_geometry(rows, k, sms)
        assert len(launches) == 1 + (k > 256 and k % 256 != 0)
        seen = np.zeros((tiles, k), np.int64)
        for bin0, group_bins, groups, blocks in launches:
            assert 0 < group_bins <= 256 and group_bins % 64 == 0
            assert bin0 % 64 == 0 and bin0 + groups * group_bins <= k
            assert blocks >= 1 and (blocks * groups <= sms or blocks == 1)
            assert blocks == max(1, min(tiles, sms // groups))
            for g in range(groups):
                first = bin0 + g * group_bins
                for b in range(blocks):
                    seen[b:tiles:blocks, first:first + group_bins] += 1
        assert (seen == 1).all()


# --- plain versions against JAX -----------------------------------------------


@pytest.mark.parametrize("k", [128, 512])
def test_k1c_plain_matches_pallas_default(k):
    """fast_time_profile_bf16 (K1c's plain version, one bf16 pass) vs JAX's
    _profile_kernel at Precision.DEFAULT in interpret mode, which the CPU
    computes as exact float32: between 40 and 80 dB (one bf16 pass; JAX
    records 55 dB for this class on the TPU), and no value further than
    1% of the profile's largest from JAX's."""
    jcfg, tcfg = _configs(k)
    raw, calib = _k1_inputs(jcfg, np.random.default_rng(k), f=12)
    w, off, x = _k1_port(tcfg, raw, calib)
    got = ftc.fast_time_profile_bf16(x, ftc.split_bf16x3(w)[0], off,
                                     tcfg.pn).numpy()
    want = np.asarray(jftp.fast_time_profile_pallas(
        jnp.asarray(raw), jnp.asarray(calib), jcfg, precision="default",
        interpret=True))
    assert got.shape == want.shape == (12, k)
    assert 40.0 < _snr_db(got, want) < 80.0
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def _peak_rows(k: int, lo: int, hi: int, threshold: float) -> np.ndarray:
    """Hand-made profile rows: a plateau, a tie with it, a threshold-equal
    value and its next float, peaks just inside and outside both gate
    edges, a flat row, a row of noise and an empty row."""
    rows = np.zeros((8, k), np.float32)
    rows[0, lo + 3:lo + 6] = 600.0  # a plateau: every bin ≥ both neighbours
    rows[0, hi - 2] = 600.0  # ties the plateau: the lowest bin goes first
    rows[1, lo + 7] = threshold  # at the threshold: not above it
    rows[1, lo + 9] = np.nextafter(np.float32(threshold), np.float32(1e9))
    rows[2, lo] = 900.0  # the gate's first and last bins are inside
    rows[2, hi] = 800.0
    rows[3, lo - 1] = 950.0  # one bin outside either edge is not
    rows[3, min(hi + 1, k - 1)] = 950.0
    rows[3, (lo + hi) // 2] = 300.0
    rows[4] = 400.0  # flat: every gated bin is a peak
    rows[5] = np.random.default_rng(k).uniform(0, 1000, k).astype(np.float32)
    rows[6, 0] = rows[6, k - 1] = 999.0  # the row's ends, outside the gate
    return rows


@pytest.mark.parametrize("targets", [1, 3])
@pytest.mark.parametrize("k", [128, 512, 1024])
def test_k7_plain_matches_pallas(k, targets):
    """search_peaks_fused (K7's plain version) vs search_peaks_pallas in
    interpret mode: idx, magnitude and valid exactly equal, invalid slots
    included (idx 0 where nothing is left)."""
    jcfg, tcfg = _configs(k, max_num_targets=targets)
    lo, hi = _gate_run(tcfg)
    assert 0 < lo < hi < k - 1
    prof = _peak_rows(k, lo, hi, tcfg.algorithm.range_threshold)
    got = dtc.search_peaks_fused(torch.as_tensor(prof), tcfg)
    want = jdet.search_peaks_pallas(jnp.asarray(prof), jcfg, interpret=True)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.magnitude.numpy(),
                                  np.asarray(want.magnitude))
    assert got.valid.any() and not got.valid.all()
    assert torch.all(got.idx[~got.valid] == 0)


# --- the kernels against their plain versions (need a card) -----------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fmcw_radar_processing_tpu_torch.utils.cplx import pin_f32_matmul

    pin_f32_matmul()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("f", [0, 9, 12, 1000])  # 9: not a whole row tile
@pytest.mark.parametrize("k", [128, 256, 320, 512])  # 320: a 64-bin group
def test_k1c_kernel_matches_plain_at_k(cuda_device, k, f):
    """K1c vs its plain version (1e-2 + 1e-5·|ref|) and vs the exact
    profile (between 40 and 80 dB) at K 128-512; F = 0 launches nothing."""
    jcfg, tcfg = _configs(k)
    raw, calib = _k1_inputs(jcfg, np.random.default_rng(k + f), f=max(f, 1))
    w, off, x = _k1_port(tcfg, raw[:f], calib, cuda_device)
    w_hi = ftc.split_bf16x3(w)[0]
    before = _lib.LAUNCHES["fast_time_profile_bf16"]
    got = ftc.fast_time_profile_bf16(x, w_hi, off, tcfg.pn)
    torch.cuda.synchronize()
    launches = len(ftc.k1c_geometry(16 * f, k, 132)) if f else 0  # 2 at K 320
    assert _lib.LAUNCHES["fast_time_profile_bf16"] == before + launches
    assert got.shape == (f, k)
    want = ftc.fast_time_profile_bf16_ref(x, w_hi, off, tcfg.pn)
    assert bool(((got - want).abs() <= 1e-2 + 1e-5 * want.abs()).all())
    if f:
        exact = ftc.fast_time_profile_ref(x, w, off, tcfg.pn)
        assert 40.0 < _snr_db(got.cpu().numpy(), exact.cpu().numpy()) < 80.0


@pytest.mark.cuda
@pytest.mark.parametrize("gate", ["default", "empty"])
@pytest.mark.parametrize("targets", [1, 3])
@pytest.mark.parametrize("k", [128, 256, 512, 1024])
def test_k7_kernel_matches_plain_at_k(cuda_device, k, targets, gate):
    """K7 vs its plain version on hand-made rows and 2,000 rows of noise
    with peaks (more frames than one block's chunk, a ragged last chunk):
    idx, magnitude and valid exactly equal, invalid slots included; with
    an empty gate nothing is valid."""
    alg = dict(max_num_targets=targets)
    if gate == "empty":
        alg.update(min_distance=R_MAX + 1.0, max_distance=R_MAX + 2.0)
    _, tcfg = _configs(k, **alg)
    _, dcfg = _configs(k)
    lo, hi = _gate_run(dcfg)
    rng = np.random.default_rng(k + targets)
    noise = rng.uniform(0, 400, (2000, k)).astype(np.float32)
    noise[rng.random(noise.shape) < 0.01] = 600.0  # ties between peaks
    prof = torch.as_tensor(np.concatenate(
        [_peak_rows(k, lo, hi, tcfg.algorithm.range_threshold), noise]),
        device=cuda_device)
    before = _lib.LAUNCHES["search_peaks_fused"]
    got = dtc.search_peaks_fused(prof, tcfg)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["search_peaks_fused"] == before + 1
    want = dtc.search_peaks_fused_ref(prof, tcfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if gate == "empty":
        assert not got.valid.any() and not got.idx.any()
    else:
        assert got.valid.any() and not got.valid.all()
