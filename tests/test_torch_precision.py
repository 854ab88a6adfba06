"""PyTorch port: ``matmul_precision`` and ``rescale_precision`` with the
TPU's pass semantics ("default" one bf16 pass, "high" three, "highest"
six), and the port's ``doppler_peaks`` and ``from_pair``.

On the card the port's float32 products take the passes; on the CPU they
are exact float32, as XLA:CPU computes them whatever the precision says.
The tests here force the pass semantics on the CPU by replacing the one
predicate that decides (utils/cplx.py::takes_mxu_passes) and hold every
site to a float64 NumPy oracle of the declared semantics: both operands
rounded to bf16 (nearest even) at "default", hi·hi + lo·hi + hi·lo of the
bf16 splits at "high", the float32 operands at "highest". The bound of a
product of inner size n is the float32 summation error of its passes,
(n + 3)·2^-24·(|a|·|b|). Unforced, every site must be bit-equal to the
exact float32 products the port computed before it took the knobs, and
agree with the JAX package on the CPU as the existing tests hold it.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmcw_radar_processing_tpu.config import AlgorithmConfig as JAlgorithmConfig
from fmcw_radar_processing_tpu.config import RadarConfig as JRadarConfig
from fmcw_radar_processing_tpu.config import default_device_config as jdefault
from fmcw_radar_processing_tpu.dsp import detection as jdet
from fmcw_radar_processing_tpu.dsp import fast_time as jft
from fmcw_radar_processing_tpu.dsp import slow_time as jst
from fmcw_radar_processing_tpu.dsp import stft as jstft
from fmcw_radar_processing_tpu.utils import cplx as jcplx
from fmcw_radar_processing_tpu_torch.config import (
    AlgorithmConfig,
    RadarConfig,
    default_device_config,
)
from fmcw_radar_processing_tpu_torch.dsp import detection as tdet
from fmcw_radar_processing_tpu_torch.dsp import fast_time as tft
from fmcw_radar_processing_tpu_torch.dsp import slow_time as tst
from fmcw_radar_processing_tpu_torch.dsp import stft as tstft
from fmcw_radar_processing_tpu_torch.parallel.mesh import make_mesh
from fmcw_radar_processing_tpu_torch.parallel import sp_recording
from fmcw_radar_processing_tpu_torch.pipeline import recording
from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import (
    make_frame_chain,
    pack_slow_time,
)
from fmcw_radar_processing_tpu_torch.pipeline.streaming import StreamingProcessor
from fmcw_radar_processing_tpu_torch.utils import cplx as tcplx

from .test_pipeline import _mixed_recording, _tpu_layout

jftp = importlib.import_module("fmcw_radar_processing_tpu.ops.fast_time_pallas")

PRECISIONS = ("default", "high", "highest")
EPS32 = 2.0 ** -24


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread, so that the tests do not oversubscribe the cores
    the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def forced(monkeypatch):
    """The TPU's pass semantics on CPU tensors."""
    monkeypatch.setattr(tcplx, "takes_mxu_passes", lambda t: True)


def _cfg(**algo) -> RadarConfig:
    return RadarConfig.create(default_device_config(), AlgorithmConfig(**algo))


# --- the float64 oracle of the declared semantics ----------------------------


def _bf16(a) -> np.ndarray:
    """float32 → bfloat16, round to nearest even, as float32 (bit
    arithmetic, independent of torch's conversion)."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def _terms64(a, precision: str) -> tuple:
    a = np.asarray(a, np.float32)
    if precision == "highest":
        return (a.astype(np.float64),)
    hi = _bf16(a)
    if precision == "default":
        return (hi.astype(np.float64),)
    return hi.astype(np.float64), _bf16(a - hi).astype(np.float64)


def _product64(a, b, precision: str, mm=np.matmul) -> np.ndarray:
    """a·b as ``precision``'s passes take it, in float64."""
    ta, tb = _terms64(a, precision), _terms64(b, precision)
    if len(ta) == 1:
        return mm(ta[0], tb[0])
    return mm(ta[0], tb[0]) + mm(ta[1], tb[0]) + mm(ta[0], tb[1])


def _bound(a, b, n: int, mm=np.matmul) -> np.ndarray:
    """The float32 summation error of a product of inner size n."""
    return (n + 3) * EPS32 * mm(np.abs(np.asarray(a, np.float64)),
                                np.abs(np.asarray(b, np.float64)))


# --- mxu_passes, precision_matmul ---------------------------------------------


@pytest.mark.parametrize("name,passes", [("default", 1), ("high", 3),
                                         ("highest", 6)])
def test_mxu_passes(name, passes):
    assert tcplx.mxu_passes(name) == passes
    jcplx.mxu_precision(name)  # a name JAX knows


def test_mxu_passes_rejects_an_unknown_name_as_jax_does():
    with pytest.raises(ValueError) as jerr:
        jcplx.mxu_precision("bf16")
    with pytest.raises(ValueError) as terr:
        tcplx.mxu_passes("bf16")
    assert str(terr.value) == str(jerr.value)
    for make in (lambda: tft.PackedFastTime.create(_cfg(), "cpu", precision="bf16"),
                 lambda: tstft.StftOperator.create(nfft=64, fs=1.0, precision="bf16")):
        with pytest.raises(ValueError, match="unknown matmul precision"):
            make()


# (shape of a, shape of b, einsum spec or None for torch.matmul)
SHAPES = {
    "matmul 2-d": ((40, 128), (128, 24), None),
    "matmul batched": ((6, 16, 128), (6, 128, 4), None),
    "einsum pair": ((5, 3, 16), (12, 16), "...tp,dp->...td"),
}


def _operands(shape: str, seed: int = 0):
    sa, sb, spec = SHAPES[shape]
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(sa) * 3.0).astype(np.float32)
    b = rng.standard_normal(sb).astype(np.float32)
    mm = np.matmul if spec is None else (lambda x, y: np.einsum(spec, x, y))
    n = sa[-1]
    return a, b, spec, mm, n


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_precision_matmul_forced_is_the_pass_semantics(forced, shape, precision):
    """Forced: within float32 summation error of the float64 product of
    the declared terms. The passes take effect: "default" lies farther
    from the exact product than that bound, "high" is not the exact float32
    product, and "highest" is it, bit for bit."""
    a, b, spec, mm, n = _operands(shape)
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    got = tcplx.precision_matmul(at, bt, precision, spec).numpy()
    want = _product64(a, b, precision, mm)
    bound = _bound(a, b, n, mm)
    assert np.all(np.abs(got - want) <= bound), float((np.abs(got - want) - bound).max())
    exact = (torch.matmul(at, bt) if spec is None else torch.einsum(spec, at, bt)).numpy()
    if precision == "default":
        assert np.abs(got - mm(a.astype(np.float64), b.astype(np.float64))).max() > bound.max()
    assert np.array_equal(got, exact) == (precision == "highest")


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_precision_matmul_unforced_cpu_is_torch_matmul(shape, precision):
    """On CPU tensors every precision is the exact float32 product itself,
    bit for bit."""
    a, b, spec, _, _ = _operands(shape, seed=1)
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    want = torch.matmul(at, bt) if spec is None else torch.einsum(spec, at, bt)
    got = tcplx.precision_matmul(at, bt, precision, spec)
    assert torch.equal(got, want)


def test_pre_split_terms_equal_the_split_of_the_call(forced):
    """An operand split beforehand (a constant, split once) gives the same
    bits as the split made in the call."""
    a, b, _, _, _ = _operands("matmul 2-d", seed=2)
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    for p in PRECISIONS:
        assert torch.equal(
            tcplx.precision_matmul(at, bt, p, b_terms=tcplx.mxu_terms(bt, p)),
            tcplx.precision_matmul(at, bt, p))


def test_high_split_is_k1a_split():
    """"high" splits as K1a's plain version does (one copy of the split):
    hi = bf16(x), lo = bf16(x − hi), both nearest even."""
    x = np.random.default_rng(3).standard_normal((64, 128)).astype(np.float32)
    hi, lo = tcplx.mxu_terms(torch.as_tensor(x), "high")
    np.testing.assert_array_equal(hi.numpy(), _bf16(x))
    np.testing.assert_array_equal(lo.numpy(), _bf16(x - _bf16(x)))
    (d,) = tcplx.mxu_terms(torch.as_tensor(x), "default")
    np.testing.assert_array_equal(d.numpy(), _bf16(x))


@pytest.mark.parametrize("precision", ["default", "high"])
def test_pair_matmul_takes_the_precision(forced, precision):
    """pair_matmul's four einsums at ``precision``: each within float32
    summation error of the declared terms."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 2, 16, 2)).astype(np.float32)
    m_re, m_im = rng.standard_normal((2, 8, 16)).astype(np.float32)
    spec = "...tp,dp->...td"
    got = tcplx.pair_matmul(torch.as_tensor(x), torch.as_tensor(m_re),
                            torch.as_tensor(m_im), spec, precision).numpy()

    def mm(a, b):
        return np.einsum(spec, a, b)

    xr, xi = x[..., 0], x[..., 1]
    want_re = _product64(xr, m_re, precision, mm) - _product64(xi, m_im, precision, mm)
    want_im = _product64(xr, m_im, precision, mm) + _product64(xi, m_re, precision, mm)
    b = 2 * (_bound(xr, m_re, 16, mm) + _bound(xi, m_im, 16, mm))
    np.testing.assert_array_less(np.abs(got[..., 0] - want_re), b + 1e-30)
    np.testing.assert_array_less(np.abs(got[..., 1] - want_im), b + 1e-30)


def test_from_pair():
    pair = np.random.default_rng(5).standard_normal((3, 4, 2)).astype(np.float32)
    want = jcplx.from_pair(pair)
    np.testing.assert_array_equal(tcplx.from_pair(pair), want)
    np.testing.assert_array_equal(tcplx.from_pair(torch.as_tensor(pair)), want)


# --- PackedFastTime ----------------------------------------------------------


def _fast_time_inputs(cfg, seed: int, f: int = 12):
    frames, calib = _mixed_recording(cfg, np.random.default_rng(seed), f=f)
    raw = tcplx.to_pair(_tpu_layout(frames)).reshape(f, cfg.pn, 2 * cfg.nts)
    return raw, tcplx.to_pair(calib)


def test_packed_fast_time_takes_the_config_knob():
    for p in PRECISIONS:
        cfg = _cfg(matmul_precision=p)
        assert tft.PackedFastTime.create(cfg, "cpu").precision == p
        assert tft.PackedFastTime.create(cfg, "cpu", precision="high").precision == "high"
    chain_cfg = _cfg(matmul_precision="default")
    assert tft.PackedFastTime.create(chain_cfg, "cpu", torch.bfloat16).precision == "default"


@pytest.mark.parametrize("seed", [0, 1])
def test_packed_profile_high_matches_jax_b3_kernel(forced, seed):
    """PackedFastTime.profile at matmul_precision="high", forced, against
    JAX's bf16x3 kernel (``_profile_kernel_b3``) in interpret mode, whose
    CPU dots keep x_lo and w_lo in float32 where the passes round them to
    bf16: within that rounding, 2^-16·max(|x|·|W|), and above 100 dB SNR
    (K1a's plain version against the same kernel,
    tests/test_torch_ops.py::test_k1a_plain_matches_pallas_b3)."""
    cfg = _cfg(matmul_precision="high")
    raw, calib = _fast_time_inputs(cfg, seed)
    pft = tft.PackedFastTime.create(cfg, "cpu")
    got = pft.profile(torch.as_tensor(raw), torch.as_tensor(calib)).numpy()
    jcfg = JRadarConfig.create(jdefault(), JAlgorithmConfig())
    want = np.asarray(jftp.fast_time_profile_pallas(
        jnp.asarray(raw), jnp.asarray(calib), jcfg, interpret=True,
        precision="high"))
    x = raw.reshape(-1, 2 * cfg.nts)
    bound = 2.0 ** -16 * float((np.abs(x) @ np.abs(pft.w)).max())
    assert np.abs(got - want).max() <= bound
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert -20 * np.log10(err) > 100.0
    exact = tft.PackedFastTime.create(cfg, "cpu", precision="highest").profile(
        torch.as_tensor(raw), torch.as_tensor(calib)).numpy()
    assert not np.array_equal(got, exact)


def _rf_at_bins_case(cfg, seed: int = 6):
    raw, calib = _fast_time_inputs(cfg, seed, f=5)
    idx = np.random.default_rng(seed).integers(
        0, cfg.range_fft_size, (5, 3)).astype(np.int32)
    return raw, calib, idx


@pytest.mark.parametrize("precision", PRECISIONS)
def test_rf_at_bins_forced_is_the_pass_semantics(forced, precision):
    """The gathered-weight recompute at ``precision``: within the float32
    summation error of the declared product, minus the exact offset."""
    cfg = _cfg(matmul_precision=precision)
    raw, calib, idx = _rf_at_bins_case(cfg)
    pft = tft.PackedFastTime.create(cfg, "cpu")
    got = pft.rf_at_bins(torch.as_tensor(raw), torch.as_tensor(calib),
                         torch.as_tensor(idx)).numpy()  # [F, PN, T, 2]
    f, t = idx.shape
    cols = (idx[..., None] * 2 + np.arange(2)).reshape(f, 2 * t)
    w_sel = np.stack([pft.w[:, c] for c in cols])  # [F, 2NTS, 2T]
    y = _product64(raw, w_sel, precision)  # [F, PN, 2T]
    off = calib.reshape(1, -1).astype(np.float64) @ pft.w.astype(np.float64)
    off = off.reshape(cfg.range_fft_size, 2)[idx]  # [F, T, 2]
    want = y.reshape(f, cfg.pn, t, 2) - off[:, None]
    n = 2 * cfg.nts
    bound = (_bound(raw, w_sel, n).reshape(f, cfg.pn, t, 2)
             + (n + 3) * EPS32 * (np.abs(calib.reshape(1, -1)) @ np.abs(pft.w))
             .reshape(-1, 2)[idx][:, None])
    assert np.all(np.abs(got - want) <= bound)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_rf_at_bins_unforced_cpu_unchanged_and_matches_jax(precision):
    """Unforced on the CPU: bit-equal to the exact batched product the port
    computed before the knob (torch.bmm), and within the JAX package's
    impl-vs-impl tolerance (rtol 1e-5, atol 1e-2) of JAX's rf_at_bins at
    the same precision, as tests/test_torch_dsp.py holds it."""
    cfg = _cfg(matmul_precision=precision)
    raw, calib, idx = _rf_at_bins_case(cfg, seed=7)
    pft = tft.PackedFastTime.create(cfg, "cpu")
    r, c, i = torch.as_tensor(raw), torch.as_tensor(calib), torch.as_tensor(idx)
    got = pft.rf_at_bins(r, c, i)
    f, t = idx.shape
    cols = (i.to(torch.int64)[..., None] * 2 + torch.arange(2)).reshape(f, 2 * t)
    before = torch.bmm(r.reshape(f, -1, 2 * cfg.nts),
                       pft.w_t.T[cols].transpose(1, 2)).reshape(f, cfg.pn, t, 2)
    before = before - pft.offset(c)[i.to(torch.int64)][:, None]
    assert torch.equal(got, before)
    jcfg = JRadarConfig.create(jdefault(), JAlgorithmConfig(matmul_precision=precision))
    want = jft.PackedFastTime.create(jcfg).rf_at_bins(
        jnp.asarray(raw), jnp.asarray(calib), jnp.asarray(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-2)
    assert torch.equal(pft.profile(r, c), tft.PackedFastTime.create(
        cfg, "cpu", precision="highest").profile(r, c))


# --- StftOperator and the rescale --------------------------------------------

OP_KW = dict(window_length=20, beta=3.0, nfft=64, fs=1250.0, hop=1)


def _stft_signal(seed: int = 8, length: int = 300) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(length)
    return (1.5 + np.sin(2 * np.pi * 0.11 * t) + 0.2 * rng.standard_normal(length)
            ).astype(np.float32)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_stft_operator_forced_is_the_pass_semantics(forced, precision):
    """The stacked product A2·frames at ``precision``: the PSD within the
    float32 error of |s|² given the product's summation bound b_s,
    scale·dbl·(2(|s_re| + |s_im|)·b_s + b_s²) + 8·2^-24·P."""
    x = _stft_signal()
    op = tstft.StftOperator.create(**OP_KW, precision=precision)
    got = op(torch.as_tensor(x)).power.numpy()
    a2 = np.concatenate([op.a_re, op.a_im])
    frames = np.lib.stride_tricks.sliding_window_view(x, 20).T  # [W, T]
    s2 = _product64(a2, frames, precision)
    nb = op.num_bins
    dbl = np.full((nb, 1), 2.0)
    dbl[0] = dbl[-1] = 1.0
    scale = np.float64(np.float32(op.scale)) * dbl
    want = (s2[:nb] ** 2 + s2[nb:] ** 2) * scale
    b_s = _bound(a2, frames, 20)
    b_s = np.maximum(b_s[:nb], b_s[nb:])
    bound = (scale * (2 * (np.abs(s2[:nb]) + np.abs(s2[nb:])) * b_s + 2 * b_s ** 2)
             + 8 * EPS32 * want)
    assert np.all(np.abs(got - want) <= bound)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_stft_operator_unforced_cpu_unchanged_and_matches_jax(precision):
    """Unforced: bit-equal to the exact torch.matmul of the stacked operator
    and the frame matrix, and within rtol 1e-5 (atol 1e-6 of the peak) of
    JAX's StftOperator at the same precision."""
    x = _stft_signal(seed=9)
    op = tstft.StftOperator.create(**OP_KW, precision=precision)
    got = op(torch.as_tensor(x), valid_len=280)
    a2 = torch.as_tensor(np.concatenate([op.a_re, op.a_im]))
    s2 = torch.matmul(a2, op.frame_signal(torch.as_tensor(x)))
    nb = op.num_bins
    p = (s2[:nb] * s2[:nb] + s2[nb:] * s2[nb:]) * float(np.float32(op.scale))
    p = p * op._device_operator(torch.device("cpu"))[2]
    p = torch.where(torch.arange(p.shape[1]) < 280 - 20 + 1, p, 0.0)
    assert torch.equal(got.power, p)
    want = jstft.StftOperator.create(**OP_KW, precision=precision)(
        jnp.asarray(x), valid_len=280).power
    want = np.asarray(want)
    np.testing.assert_allclose(got.power.numpy(), want, rtol=1e-5,
                               atol=1e-6 * float(want.max()))


def _db_values(seed: int = 10, nb: int = 129, t: int = 40) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = -rng.uniform(0.0, 120.0, (nb, t)).astype(np.float32)
    v[:, :3] = tstft.DB_FLOOR
    return v


@pytest.mark.parametrize("precision", PRECISIONS)
def test_log_rescale_forced_is_the_pass_semantics(forced, precision):
    """The dense contraction over the first nb−1 bins at ``precision`` plus
    the Nyquist column as an exact rank-1 float32 term (JAX's peel)."""
    v = _db_values()
    nb = v.shape[0]
    freqs = np.arange(nb, dtype=np.float32) * np.float32(1250.0 / 256)
    _, got = tstft.log_frequency_rescale(freqs, torch.as_tensor(v), 1024,
                                         precision=precision)
    w = tstft._log_interp_matrix(nb, 1024)
    want = (_product64(w[:, : nb - 1], v[: nb - 1], precision)
            + w[:, nb - 1 :].astype(np.float64) * v[nb - 1 :].astype(np.float64))
    bound = (_bound(w[:, : nb - 1], v[: nb - 1], nb - 1)
             + 2 * EPS32 * np.abs(w[:, nb - 1 :] * v[nb - 1 :]))
    assert np.all(np.abs(got.numpy() - want) <= bound)
    # The gather form stays exact whatever the precision.
    _, gathered = tstft.log_frequency_rescale(freqs, torch.as_tensor(v), 1024,
                                              precision=precision, method="gather")
    _, exact = tstft.log_frequency_rescale(freqs, torch.as_tensor(v), 1024,
                                           method="gather")
    assert torch.equal(gathered, exact)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_log_rescale_unforced_cpu_unchanged_and_matches_jax(precision):
    """Unforced: bit-equal to the exact product and rank-1 term the port
    computed before the knob, and within rtol 1e-6 / atol 1e-3 of JAX's
    log_frequency_rescale at the same precision (tests/test_torch_dsp.py's
    tolerance)."""
    v = _db_values(seed=11)
    nb = v.shape[0]
    freqs = np.arange(nb, dtype=np.float32) * np.float32(1250.0 / 256)
    vt = torch.as_tensor(v)
    _, got = tstft.log_frequency_rescale(freqs, vt, 1024, precision=precision)
    w = torch.as_tensor(tstft._log_interp_matrix(nb, 1024))
    before = (torch.matmul(w[:, : nb - 1], vt[: nb - 1])
              + w[:, nb - 1 : nb] * vt[nb - 1 : nb])
    assert torch.equal(got, before)
    _, want = jstft.log_frequency_rescale(jnp.asarray(freqs), jnp.asarray(v), 1024,
                                          precision=precision)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-3)


# --- the call sites ----------------------------------------------------------


def _recording(cfg, seed: int = 12, f: int = 24):
    frames, calib = _mixed_recording(cfg, np.random.default_rng(seed), f=f)
    return _tpu_layout(frames), calib


@pytest.mark.parametrize("matmul,rescale", [("default", "highest"),
                                            ("highest", "default"),
                                            ("high", "high")])
def test_recording_xla_branch_takes_both_knobs(forced, matmul, rescale):
    """RadarPipeline's XLA-branch export (stft_impl="xla"), forced: bit-equal
    to the chain, the STFT at matmul_precision and the rescale at
    rescale_precision composed by hand, and different from the all-
    "highest" run where a knob is below it."""
    cfg = _cfg(stft_nfft=256, stft_impl="xla", matmul_precision=matmul,
               rescale_precision=rescale)
    raw, calib = _recording(cfg)
    pipe = recording.RadarPipeline(cfg, device="cpu")
    got = pipe.process_recording(raw, calib)
    out = make_frame_chain(cfg, "cpu")(*pipe._device_inputs(raw, calib))
    sig, count = pack_slow_time(out.strongest_chirps, out.detected, cfg.pn)
    op = tstft.StftOperator.create(window_length=20, beta=3.0, nfft=256,
                                   fs=1.0 / cfg.derived.prt, precision=matmul)
    db = tstft.psd_db(op(tcplx.pair_abs(sig), valid_len=int(count)).power)
    freqs = np.arange(129, dtype=np.float32) * np.float32(op.fs / op.nfft)
    _, inten = tstft.log_frequency_rescale(freqs, db, 1024, precision=rescale)
    n = got.spectrogram_psd_db.shape[1]
    np.testing.assert_array_equal(got.spectrogram_psd_db, db[:, :n].numpy())
    np.testing.assert_array_equal(got.spectrogram_intensity, inten[:, :n].numpy())
    top = _cfg(stft_nfft=256, stft_impl="xla", matmul_precision="highest",
               rescale_precision="highest")
    ref = recording.RadarPipeline(top, device="cpu").process_recording(raw, calib)
    np.testing.assert_array_equal(got.detected, ref.detected)
    assert not np.array_equal(got.spectrogram_intensity, ref.spectrogram_intensity)
    if matmul != "highest":
        assert not np.array_equal(got.spectrogram_psd_db, ref.spectrogram_psd_db)
    else:
        np.testing.assert_array_equal(got.spectrogram_psd_db, ref.spectrogram_psd_db)


@pytest.mark.parametrize("algo", ["xla", "production"])
def test_unforced_cpu_pipeline_is_bit_equal_at_every_precision(algo):
    """With CPU operands the port is bit-for-bit what it was: every output
    of RadarPipeline at "default" and "high" equals the "highest" run's."""
    raw, calib = _recording(_cfg())
    outs = []
    for p in PRECISIONS:
        over = dict(matmul_precision=p, rescale_precision=p)
        algo_cfg = (AlgorithmConfig.production(**over) if algo == "production"
                    else AlgorithmConfig(stft_nfft=256, stft_impl="xla", **over))
        cfg = RadarConfig.create(default_device_config(), algo_cfg)
        outs.append(recording.RadarPipeline(cfg, device="cpu")
                    .process_recording(raw, calib))
    for o in outs[:2]:
        for field in ("waterfall", "target_range", "target_speed", "detected",
                      "spectrogram_intensity", "spectrogram_psd_db"):
            np.testing.assert_array_equal(getattr(o, field), getattr(outs[2], field))


def test_streaming_and_sp_sites_take_the_knobs(monkeypatch):
    """The streaming processor's STFT and the sp recording's STFT take
    matmul_precision, the sp recording's rescale rescale_precision, as
    the JAX package's streaming.py:85-92 and sp_recording.py:76-94 read
    them."""
    cfg = _cfg(stft_nfft=256, matmul_precision="default", rescale_precision="high")
    sp = StreamingProcessor(cfg, 1, 16, "cpu")
    assert sp._stft.precision == "default"
    seen = []
    real = sp_recording.log_frequency_rescale

    def spy(*args, **kw):
        seen.append(kw.get("precision"))
        return real(*args, **kw)

    monkeypatch.setattr(sp_recording, "log_frequency_rescale", spy)
    pipe = sp_recording.ShardedRecordingPipeline(cfg, make_mesh(), device="cpu")
    assert pipe.op.precision == "default"
    raw, calib = _recording(cfg, f=8)
    pipe.process(raw, calib)
    assert seen == ["high"]


def test_recording_sites_read_the_config(monkeypatch):
    """RadarPipeline's STFT operator takes matmul_precision and its
    rescale rescale_precision; the literal snapshot's packed operator
    takes matmul_precision (the JAX package's recording.py:120-127,
    184-187 and 338)."""
    cfg = _cfg(stft_nfft=256, stft_impl="xla", matmul_precision="high",
               rescale_precision="default", compat_linear_index_snapshot=True)
    seen = {"stft": [], "rescale": [], "packed": []}
    real_op, real_rescale = recording.StftOperator.create, recording.log_frequency_rescale
    real_packed = recording.PackedFastTime.create

    def op(**kw):
        seen["stft"].append(kw.get("precision"))
        return real_op(**kw)

    def rescale(*args, **kw):
        seen["rescale"].append(kw.get("precision"))
        return real_rescale(*args, **kw)

    def packed(*args, **kw):
        pft = real_packed(*args, **kw)
        seen["packed"].append(pft.precision)
        return pft

    monkeypatch.setattr(recording.StftOperator, "create", op)
    monkeypatch.setattr(recording, "log_frequency_rescale", rescale)
    monkeypatch.setattr(recording.PackedFastTime, "create", packed)
    raw, calib = _recording(cfg, f=12)
    recording.RadarPipeline(cfg, device="cpu").process_recording(raw, calib)
    # PackedFastTime.create: the chain's, then the literal snapshot's.
    assert seen == {"stft": ["high"], "rescale": ["default"],
                    "packed": ["high", "high"]}


# --- doppler_peaks -----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_doppler_peaks_full_map_matches_jax(seed):
    """The full-map variant against JAX's on seeded maps [F, K, D, 2]:
    Doppler bins exact, speeds rtol 1e-6; and equal to doppler_peaks_at on
    the gathered rows."""
    cfg = _cfg()
    jcfg = JRadarConfig.create(jdefault(), JAlgorithmConfig())
    rng = np.random.default_rng(seed)
    f, k, d = 6, cfg.range_fft_size, cfg.doppler_fft_size
    rd = (rng.standard_normal((f, k, d, 2)) * 40.0).astype(np.float32)
    rd[0, :, cfg.zero_doppler_bin] *= 50.0  # a static frame
    profile = np.abs(rng.standard_normal((f, k))).astype(np.float32) * 50.0
    det_t = tdet.search_peaks(torch.as_tensor(profile), cfg)
    det_j = jdet.search_peaks(jnp.asarray(profile), jcfg)
    np.testing.assert_array_equal(det_t.idx.numpy(), np.asarray(det_j.idx))
    got = tst.doppler_peaks(torch.as_tensor(rd), det_t, cfg)
    want = jst.doppler_peaks(jnp.asarray(rd), det_j, jcfg)
    np.testing.assert_array_equal(got.doppler_idx.numpy(), np.asarray(want.doppler_idx))
    np.testing.assert_allclose(got.speed.numpy(), np.asarray(want.speed), rtol=1e-6)
    assert (got.doppler_idx.numpy() == cfg.zero_doppler_bin).any()
    rows = torch.as_tensor(rd)[torch.arange(f)[:, None], det_t.idx.to(torch.int64)]
    at = tst.doppler_peaks_at(rows, cfg)
    assert torch.equal(at.doppler_idx, got.doppler_idx)
    assert torch.equal(at.speed, got.speed)
