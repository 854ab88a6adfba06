"""PyTorch port: the six-pass arithmetic of K1b and K6 (the TPU's
Precision.HIGHEST as six bf16 passes on the tensor cores) and K5b (K3's
kernel recomputing its PSD), on the CPU.

The kernels run only on the card; here their plain versions are held to the
JAX package (its Pallas kernels in interpret mode, as its own tests run them)
and to float64 sums of the same operands, and the wrappers' dispatch to the
kernel launches is checked against a stub library on meta tensors.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fmcw_radar_processing_tpu.dsp.stft import StftOperator as JStftOperator
from fmcw_radar_processing_tpu_torch.dsp.stft import DB_FLOOR, StftOperator
from fmcw_radar_processing_tpu_torch.ops import _lib
from fmcw_radar_processing_tpu_torch.ops import fast_time_cuda as ftc
from fmcw_radar_processing_tpu_torch.ops import stft_cuda as stc

from .test_torch_ops import (
    OP_KW,
    _check_dtype_only,
    _fail_if_called,
    _k1_inputs,
    _k1_port,
    _launch_deltas,
    _signal,
    _snr_db,
    _stub_library,
    assert_within_one_bf16_ulp,
)

jftp = importlib.import_module("fmcw_radar_processing_tpu.ops.fast_time_pallas")
jstp = importlib.import_module("fmcw_radar_processing_tpu.ops.stft_pallas")

# float32 values whose two remainders stay normal: |t| in [2^-100, 2^100].
_NORMAL = st.floats(min_value=2.0 ** -100, max_value=2.0 ** 100, width=32)
_VALUES = st.lists(st.one_of(st.just(0.0), _NORMAL, _NORMAL.map(lambda v: -v)),
                   min_size=1, max_size=64)


# --- the three-term split -------------------------------------------------


@settings(max_examples=200, deadline=None)
@given(_VALUES)
def test_split_bf16x6_is_exact(values):
    """t1 + t2 + t3 == t bit for bit (24 bits in three 8-bit terms, each
    remainder exact in float32), each term a bf16 rounding of what is left."""
    t = torch.tensor(values, dtype=torch.float32)
    t1, t2, t3 = ftc.split_bf16x6(t)
    assert t1.dtype == t2.dtype == t3.dtype == torch.bfloat16
    f1, f2, f3 = (a.to(torch.float32) for a in (t1, t2, t3))
    assert torch.equal((f1 + f2) + f3, t)
    assert torch.equal(t1, t.to(torch.bfloat16))
    assert torch.equal(t2, (t - f1).to(torch.bfloat16))
    assert torch.equal(f3, t - f1 - f2)  # the last remainder fits bf16


def test_split_bf16x6_of_the_weight_is_exact(cfg):
    """The blocked weight's three terms sum back to it exactly, and its first
    two are split_bf16x3's halves (the six passes extend K1a's split)."""
    w = ftc.blocked_weight(cfg, "cpu")
    w1, w2, w3 = ftc.split_bf16x6(w)
    assert torch.equal(w1.float() + w2.float() + w3.float(), w)
    w_hi, w_lo = ftc.split_bf16x3(w)
    assert torch.equal(w1, w_hi) and torch.equal(w2, w_lo)
    assert bool((w3 != 0).any())  # the third term carries bits K1a drops


# --- the six-pass plain versions -----------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_b6_plain_matches_f64_of_the_split(cfg, seed):
    """The six-pass plain profile and cube vs the same six products of the
    same bf16 terms summed in float64 (the offset as given): rtol 1e-5, and
    atol 1e-6·max|y| where the float32 sums of the large partial products
    cancel (|y| reaches 4.5e4 here; float32's own exact product is 0.03 off
    float64 there)."""
    raw, calib = _k1_inputs(cfg, np.random.default_rng(seed))
    w, off, x = _k1_port(cfg, raw, calib)
    x1, x2, x3 = (a.to(torch.float64).numpy() for a in ftc.split_bf16x6(x))
    w1, w2, w3 = (a.to(torch.float64).numpy() for a in ftc.split_bf16x6(w))
    y = (x1 @ w2 + x2 @ w1 + x1 @ w3 + x2 @ w2 + x3 @ w1 + x1 @ w1
         - off.numpy().astype(np.float64))
    k = cfg.range_fft_size
    want = np.sqrt(y[:, :k] ** 2 + y[:, k:] ** 2).reshape(-1, cfg.pn, k).max(1)
    atol = 1e-6 * float(np.abs(y).max())
    got = ftc.fast_time_profile_b6_ref(x, w, off, cfg.pn)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol)
    rf, prof = ftc.fast_time_b6_ref(x, w, off, cfg.pn)
    assert torch.equal(prof, got)
    want_rf = np.stack([y[:, :k], y[:, k:]], -1).reshape(-1, cfg.pn, k, 2)
    np.testing.assert_allclose(rf.numpy(), want_rf, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("kernel", ["profile", "fast_time"])
@pytest.mark.parametrize("f", [9, 10, 12])  # 9, 10: not whole groups
def test_b6_plain_matches_pallas_highest(cfg, f, kernel):
    """The six-pass plain versions of K1b and K6 vs the JAX package's
    HIGHEST kernels in interpret mode (fast_time_profile_pallas's
    _profile_kernel, fast_time_pallas's _kernel), at least 120 dB (the
    card's aim for K1b and K6 against the exact profile): the profile
    within the JAX package's bound between its Pallas and XLA chains, rtol
    1e-5 / atol 1e-2; the cube within its bound between two summation
    orders, rtol 1e-5 / atol 1e-5·max|rf| (tests/test_fused_chain.py:73-90),
    since the six passes round their float32 sums elsewhere than one exact
    product does."""
    raw, calib = _k1_inputs(cfg, np.random.default_rng(f), f=f)
    w, off, x = _k1_port(cfg, raw, calib)
    if kernel == "profile":
        got = ftc.fast_time_profile_b6_ref(x, w, off, cfg.pn).numpy()
        want = np.asarray(jftp.fast_time_profile_pallas(
            jnp.asarray(raw), jnp.asarray(calib), cfg, precision="highest"))
    else:
        rf, prof = ftc.fast_time_b6_ref(x, w, off, cfg.pn)
        rf_j, want = (np.asarray(a) for a in jftp.fast_time_pallas(
            jnp.asarray(raw), jnp.asarray(calib), cfg, interpret=True))
        np.testing.assert_allclose(rf.numpy(), rf_j, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(rf_j).max()))
        assert _snr_db(rf.numpy(), rf_j) >= 120.0
        got = prof.numpy()
    assert got.shape == want.shape == (f, cfg.range_fft_size)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-2)
    assert _snr_db(got, want) >= 120.0


# --- K1b and K6 dispatch ---------------------------------------------------


@pytest.mark.parametrize("f", [12, 9, 0])
def test_fast_time_profile_dispatch_on_device_tensors(monkeypatch, f):
    """K1b on a device tensor: one fast_time_profile launch (rows, K) with
    the float32 weight (the kernel splits it), a [F, K] float32 profile,
    never a plain version (F = 0: no launch); a bf16 weight, a ragged frame
    or another PN raises first."""
    stub = _stub_library(monkeypatch)
    for name in ("fast_time_profile_ref", "fast_time_profile_b6_ref"):
        monkeypatch.setattr(ftc, name, _fail_if_called)
    monkeypatch.setattr(_lib, "check_operand", _check_dtype_only)
    before = dict(_lib.LAUNCHES)
    meta = dict(device="meta", dtype=torch.float32)
    x = torch.empty(f * 16, 128, **meta)
    w, off = torch.empty(128, 512, **meta), torch.empty(512, **meta)
    prof = ftc.fast_time_profile(x, w, off, 16)
    assert prof.shape == (f, 256) and prof.dtype == torch.float32
    if f:
        (name, args), = stub.calls
        assert name == "fast_time_profile_launch" and args[4:6] == (f * 16, 256)
        assert args[1] == w.data_ptr()
    assert _launch_deltas(before) == {
        k: int(k == "fast_time_profile" and f > 0) for k in before}
    for bad in (dict(w=torch.empty(128, 512, device="meta", dtype=torch.bfloat16)),
                dict(x=torch.empty(f * 16 + 8, 128, **meta)), dict(pn=8)):
        kw = dict(x=x, w=w, off=off, pn=16) | bad
        with pytest.raises(ValueError):
            ftc.fast_time_profile(**kw)
    assert len(stub.calls) == int(f > 0)


def test_fast_time_argument_rules(monkeypatch):
    """K6 takes what K1b takes: a bf16 weight, a K that is not a whole
    64-bin slice, or a ragged frame raises before any launch; F = 0
    launches nothing and returns empty outputs."""
    stub = _stub_library(monkeypatch)
    for name in ("fast_time_ref", "fast_time_b6_ref"):
        monkeypatch.setattr(ftc, name, _fail_if_called)
    monkeypatch.setattr(_lib, "check_operand", _check_dtype_only)
    meta = dict(device="meta", dtype=torch.float32)
    x = torch.empty(32, 128, **meta)
    w, off = torch.empty(128, 512, **meta), torch.empty(512, **meta)
    for bad in (dict(w=torch.empty(128, 512, device="meta", dtype=torch.bfloat16)),
                dict(w=torch.empty(128, 448, **meta), off=torch.empty(448, **meta)),
                dict(x=torch.empty(40, 128, **meta))):
        with pytest.raises(ValueError):
            ftc.fast_time(**(dict(x=x, w=w, off=off, pn=16) | bad))
    rf, prof = ftc.fast_time(torch.empty(0, 128, **meta), w, off, 16)
    assert rf.shape == (0, 16, 256, 2) and prof.shape == (0, 256)
    assert stub.calls == []


# --- K5b --------------------------------------------------------------------


@pytest.mark.parametrize("int_dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("nb", [129, 216, 265])  # nb_pad 136, 216, 272
def test_db_rescale_recompute_dispatch_and_rules(monkeypatch, nb, int_dtype):
    """K5b on device tensors: one db_rescale_recompute launch with nb_pad,
    nv, t_pad, the 1,024 output rows and the intensity's dtype code, a
    float32 dB map [nb_pad, t_pad] and the intensity [1024, t_pad] in its
    dtype, never the plain version; past nb_pad 272, a t_pad that is not
    whole 1,024-column tiles, nb past nb_pad or an unknown intensity dtype
    raise before any launch."""
    stub = _stub_library(monkeypatch)
    monkeypatch.setattr(stc, "db_rescale_recompute_ref", _fail_if_called)
    before = dict(_lib.LAUNCHES)
    nb_pad = -(-nb // 8) * 8
    meta = dict(device="meta", dtype=torch.float32)
    sig, gmax = torch.empty(3000, **meta), torch.empty((), **meta)
    a2 = torch.empty(2 * nb_pad, 20, **meta)
    db, out = stc.db_rescale_recompute(sig, 2481, a2, gmax, nb, 1024, 3072,
                                       int_dtype)
    assert db.shape == (nb_pad, 3072) and db.dtype == torch.float32
    assert out.shape == (1024, 3072) and out.dtype == int_dtype
    (name, args), = stub.calls
    assert name == "db_rescale_recompute_launch"
    assert (args[1], args[3], args[4], args[9], args[10], args[13]) == (
        3000, nb_pad, 2481, 3072, 1024, stc._DTYPE_CODE[int_dtype])
    assert _launch_deltas(before) == {
        k: int(k == "db_rescale_recompute") for k in before}
    for bad in (dict(a2=torch.empty(2 * 280, 20, **meta)),  # nb_pad 280
                dict(t_pad=3000), dict(nb=nb_pad + 1),
                dict(int_dtype=torch.float16)):
        kw = dict(sig=sig, nv=2481, a2=a2, gmax=gmax, nb=nb, num_bins=1024,
                  t_pad=3072, int_dtype=int_dtype) | bad
        with pytest.raises(ValueError):
            stc.db_rescale_recompute(**kw)
    assert len(stub.calls) == 1


def _jax_recompute(sig, count, nfft, **kw):
    op = JStftOperator.create(**{**OP_KW, "nfft": nfft})
    out = jstp.spectrogram_pallas(jnp.asarray(sig), jnp.asarray(count), op,
                                  tile=512, recompute=True, **kw)
    return out[0], *(np.asarray(a).astype(np.float32) if a.dtype == jnp.bfloat16
                     else np.asarray(a) for a in out[1:])


@pytest.mark.parametrize("int_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nfft", [430, 500])  # nb_pad 216 and 256: past 208
def test_recompute_past_k3_wide_tiles_matches_pallas(nfft, int_dtype):
    """The recompute export where K3 takes 64-column tiles and K5b still
    128 (208 < nb_pad ≤ 272): psd None, db and intensity bit-equal to the
    port's materializing export; vs JAX's spectrogram_pallas(recompute=True)
    in interpret mode, dB atol 1e-3 above −120 dB with the floors equal, and
    the intensity atol 2e-3 (float32) or one bf16 ulp above −120 dB
    (tests/test_stft_pallas.py's bounds)."""
    sig = _signal(4096, 3000)
    op = StftOperator.create(**{**OP_KW, "nfft": nfft})
    p, db, intensity = stc.spectrogram(torch.as_tensor(sig), 3000, op,
                                       intensity_dtype=int_dtype, recompute=True)
    assert p is None and db.dtype == torch.float32
    _, db_m, int_m = stc.spectrogram(torch.as_tensor(sig), 3000, op,
                                     intensity_dtype=int_dtype)
    assert torch.equal(db, db_m) and torch.equal(intensity, int_m)
    jdtype = jnp.bfloat16 if int_dtype == torch.bfloat16 else jnp.float32
    p_j, db_j, int_j = _jax_recompute(sig, 3000, nfft, intensity_dtype=jdtype)
    assert p_j is None and db.shape == db_j.shape == (op.num_bins, 4077)
    db = db.numpy()
    m = db_j > -120
    np.testing.assert_allclose(db[m], db_j[m], atol=1e-3)
    np.testing.assert_array_equal(db == DB_FLOOR, db_j == DB_FLOOR)
    if int_dtype == torch.bfloat16:
        assert_within_one_bf16_ulp(intensity.float().numpy(), int_j,
                                   int_j > -120, 2e-3)
    else:
        mi = int_j > -120
        np.testing.assert_allclose(intensity.numpy()[mi], int_j[mi], atol=2e-3)
