"""PyTorch port: the export's phase-1 knobs ``psd_precision`` and
``psd_store_dtype`` (``AlgorithmConfig.stft_psd_precision`` and
``stft_psd_store``) against the JAX package's ``spectrogram_pallas`` and
pipeline on the CPU.

On the CPU the wrappers run their plain versions: K2a's bf16x3 form
(``psd_phase1_b3_ref``) for "high", the exact form otherwise, each with the
bf16 PSD store's rounding. The JAX side runs its Pallas kernels in
interpret mode, as its own tests do; there the bf16x3 kernel's low halves
are multiplied unrounded (the TPU's bf16 passes round them), so against
"high" the deep nulls differ and are left out (below −120 dB). A bf16 PSD
value of the two sides may differ by one bf16 ulp where the float32 PSDs,
a float32 rounding apart, straddle a rounding boundary; everything else is
equal.
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
from fmcw_radar_processing_tpu_torch.config import AlgorithmConfig as TAlgorithmConfig
from fmcw_radar_processing_tpu_torch.config import RadarConfig as TRadarConfig
from fmcw_radar_processing_tpu_torch.config import (
    default_device_config as t_default_device_config,
)
from fmcw_radar_processing_tpu_torch.dsp.stft import DB_FLOOR, StftOperator
from fmcw_radar_processing_tpu_torch.ops import _lib
from fmcw_radar_processing_tpu_torch.ops import stft_cuda as stc
from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline

from .test_pipeline import _mixed_recording, _tpu_layout
from .test_torch_ops import (
    OP_KW,
    _bf16_ulp,
    _fail_if_called,
    _launch_deltas,
    _signal,
    _snr_db,
    _stub_library,
    assert_within_one_bf16_ulp,
)

jstp = importlib.import_module("fmcw_radar_processing_tpu.ops.stft_pallas")

CASES = [(4096, 4000), (4096, 1000), (700, 650)]


def _jax(sig, count, nfft=256, **kw):
    op = JStftOperator.create(**{**OP_KW, "nfft": nfft})
    out = jstp.spectrogram_pallas(jnp.asarray(sig), jnp.asarray(count), op,
                                  tile=512, **kw)
    return [None if a is None else np.asarray(a).astype(np.float32)
            for a in out]


def _port(sig, count, nfft=256, **kw):
    op = StftOperator.create(**{**OP_KW, "nfft": nfft})
    return stc.spectrogram(torch.as_tensor(sig), count, op, **kw)


def _np(out):
    return [None if a is None else a.float().numpy() for a in out]


# --- psd_precision="high": K2a's plain version ------------------------------


@pytest.mark.parametrize("l,count", CASES)
def test_high_matches_pallas_high(l, count):
    """vs spectrogram_pallas(psd_precision="high"): PSD within 1e-5·gmax
    (measured 4.4e-6), dB within 0.02 dB where JAX's is above −120 dB
    (measured 0.016), intensity within 1e-3 dB on the display band
    (measured 5e-4), floors equal."""
    sig = _signal(l, count)
    p, db, intensity = _np(_port(sig, count, psd_precision="high"))
    p_j, db_j, int_j = _jax(sig, count, psd_precision="high")
    assert p.shape == p_j.shape and intensity.shape == int_j.shape
    gmax = float(p_j.max())
    assert np.abs(p - p_j).max() <= 1e-5 * gmax
    m = db_j > -120
    assert np.abs(db - db_j)[m].max() <= 0.02
    np.testing.assert_array_equal(db == DB_FLOOR, db_j == DB_FLOOR)
    band = int_j > -40
    assert band.sum() > 1000
    assert np.abs(intensity - int_j)[band].max() <= 1e-3
    ncols = count - 19
    assert np.all(p[:, ncols:] == 0.0) and np.all(db[:, ncols:] == DB_FLOOR)


@pytest.mark.parametrize("l,count", CASES)
def test_high_against_the_exact_form(l, count):
    """bf16x3 against the exact PSD: above 100 dB (measured 111 dB), and
    the intensity within 1e-3 dB of the exact export's on the display band
    (measured 5.3e-4)."""
    sig = _signal(l, count)
    p, _, intensity = _np(_port(sig, count, psd_precision="high"))
    p_x, _, int_x = _np(_port(sig, count))
    assert _snr_db(p, p_x) > 100.0
    band = int_x > -40
    assert np.abs(intensity - int_x)[band].max() <= 1e-3


def test_b3_plain_version_is_the_split():
    """psd_phase1_b3_ref is the split it states: against the three products
    of the bf16-rounded halves summed in float64, within 1e-6·gmax."""
    sig = torch.as_tensor(_signal(4096, 3000))
    op = StftOperator.create(**OP_KW)
    a2 = torch.as_tensor(stc._folded_operator(op, 16))
    nb_pad, t_pad = a2.shape[0] // 2, 4096
    p, tmax = stc.psd_phase1_b3_ref(sig, 3000 - 19, a2, nb_pad, t_pad)

    def bf16(x):
        return x.to(torch.bfloat16).to(torch.float64)

    a = a2.double()
    a_hi, x = bf16(a), torch.nn.functional.pad(sig.double(), (0, t_pad + 19 - 4096))
    a_lo, x_hi = bf16(a - a_hi), bf16(x)
    x_lo = bf16(x - x_hi)
    f_hi, f_lo = x_hi.unfold(0, 20, 1).T, x_lo.unfold(0, 20, 1).T
    s2 = a_hi @ f_hi + a_hi @ f_lo + a_lo @ f_hi
    want = s2[:nb_pad] ** 2 + s2[nb_pad:] ** 2
    want[:, 3000 - 19:] = 0.0
    gmax = float(want.max())
    assert float((p.double() - want).abs().max()) <= 1e-6 * gmax
    assert tmax.shape == (t_pad // stc.PSD_TILE,)
    np.testing.assert_allclose(float(tmax.max()), gmax, rtol=1e-6)


# --- psd_store_dtype=bfloat16 -------------------------------------------------


def _assert_bf16_psd_close(p, p_j):
    """Both bf16-valued: equal but for values a float32 rounding from a bf16
    rounding boundary, each of those one bf16 ulp apart (at most 1e-5 of
    the values; 3 of 525,933 in the largest case here)."""
    diff = np.abs(p - p_j)
    ne = diff > 0
    assert ne.mean() <= 1e-5
    assert np.all(diff[ne] <= _bf16_ulp(np.maximum(p, p_j))[ne] * 1.0001)


@pytest.mark.parametrize("l,count", CASES)
def test_bf16_psd_store_matches_pallas(l, count):
    """vs spectrogram_pallas(psd_store_dtype=bfloat16): the psd slot bf16,
    its values JAX's bf16 PSD (see _assert_bf16_psd_close), gmax the max of
    the rounded values on both sides; where the PSD is equal, dB and
    intensity within 2e-3 dB (measured 8e-6), elsewhere within the dB of
    one bf16 ulp. The parent ignored the store dtype: 0.039 dB apart."""
    sig = _signal(l, count)
    out = _port(sig, count, psd_store_dtype=torch.bfloat16)
    assert out[0].dtype == torch.bfloat16
    p, db, intensity = _np(out)
    p_j, db_j, int_j = _jax(sig, count, psd_store_dtype=jnp.bfloat16)
    assert p.shape == p_j.shape and intensity.shape == int_j.shape
    _assert_bf16_psd_close(p, p_j)
    assert p.max() == p_j.max()
    ulp_db = 20 * np.log10(1 + 2.0 ** -7)
    same = p == p_j
    m = db_j > -120
    d = np.abs(db - db_j)
    assert d[m & same].max() <= 2e-3 and d[m].max() <= ulp_db
    np.testing.assert_array_equal(db == DB_FLOOR, db_j == DB_FLOOR)
    # An intensity row interpolates two neighbouring bins: equal PSD there
    # means within 2e-3 dB.
    i0, _, _ = stc._log_interp_gather(p.shape[0], intensity.shape[0])
    both = same[i0] & same[i0 + 1]
    mi = int_j > -120
    di = np.abs(intensity - int_j)
    assert di[mi & both].max() <= 2e-3 and di[mi].max() <= ulp_db


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_bf16_psd_store_is_the_rounded_psd(precision):
    """The bf16 store rounds the float32 PSD of the same precision (round
    to nearest even) and takes the max of the rounded values; dB and
    intensity are those of the rounded PSD."""
    sig = _signal(4096, 3000)
    p32 = _port(sig, 3000, psd_precision=precision)[0]
    p, db, intensity = _port(sig, 3000, psd_precision=precision,
                             psd_store_dtype=torch.bfloat16)
    assert torch.equal(p, p32.to(torch.bfloat16))
    op = StftOperator.create(**OP_KW)
    pq = p.float()
    db_w, int_w = stc.db_rescale_ref(pq, pq.amax(), op.num_bins, 1024,
                                     torch.float32, torch.float32)
    assert torch.equal(db, db_w) and torch.equal(intensity, int_w)


# --- the pipeline ---------------------------------------------------------------


@pytest.mark.parametrize("store", ["bfloat16", "float32"])
def test_production_pipeline_psd_store_matches_jax(cfg, rng, store):
    """RadarPipeline(device="cpu") vs the JAX pipeline under
    production(stft_impl="pallas", stft_psd_store=store): bf16 dB map and
    intensity (the production stores) within one bf16 ulp above −120 dB,
    floors equal, and at least 99% of those values equal (measured 99.8%
    and 99.9% with the bf16 PSD store; the parent, which ignored it, 92%
    and 64%); the payload's intensity is the array's."""
    frames, calib = _mixed_recording(cfg, rng, f=48)
    raw = _tpu_layout(frames)
    got = RadarPipeline(
        TRadarConfig.create(t_default_device_config(),
                            TAlgorithmConfig.production(stft_psd_store=store)),
        device="cpu").process_recording(raw, calib)
    want = JaxPipeline(
        RadarConfig.create(default_device_config(),
                           AlgorithmConfig.production(stft_impl="pallas",
                                                      stft_psd_store=store)),
        impl="pallas_profile_high").process_recording(raw, calib)
    np.testing.assert_array_equal(got.detected, want.detected)
    payload = got.payloads["spectrogram_data.json"]
    want_payload = want.payloads["spectrogram_data.json"]
    assert payload.keys() == want_payload.keys()
    for key in ("time", "frequency"):
        np.testing.assert_array_equal(payload[key], want_payload[key])
    for a, b in ((payload["intensity"], want_payload["intensity"]),
                 (got.spectrogram_psd_db, want.spectrogram_psd_db)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape
        m = b > -120
        assert_within_one_bf16_ulp(a, b, m, 1e-3)
        np.testing.assert_array_equal(a == DB_FLOOR, b == DB_FLOOR)
        assert (a == b)[m].mean() >= 0.99


@pytest.mark.parametrize("nfft", [1024, 2048])
def test_pipeline_downgrades_past_nb_pad_512(cfg, rng, nfft):
    """production(stft_nfft > 512, stft_psd_store="bfloat16"): as in JAX
    (its resolves_tiled), the export runs exact with float32 stores —
    the port's result equals its run under psd_precision "highest" and
    float32 stores, and matches the JAX pipeline's with the bounds of
    test_torch_fidelity.py's production_pinned_large_nfft test (dB within
    1e-3 dB above −40 dB, floors equal; bf16 intensity within one ulp
    above −120 dB)."""
    frames, calib = _mixed_recording(cfg, rng, f=24)
    raw = _tpu_layout(frames)
    dev = t_default_device_config()
    got = RadarPipeline(
        TRadarConfig.create(dev, TAlgorithmConfig.production(
            stft_nfft=nfft, stft_psd_store="bfloat16")),
        device="cpu").process_recording(raw, calib)
    exact = RadarPipeline(
        TRadarConfig.create(dev, TAlgorithmConfig.production(
            stft_nfft=nfft, stft_psd_precision="highest",
            stft_db_store="float32")),
        device="cpu").process_recording(raw, calib)
    want = JaxPipeline(
        RadarConfig.create(default_device_config(), AlgorithmConfig.production(
            stft_nfft=nfft, stft_impl="pallas", stft_psd_store="bfloat16")),
        impl="pallas_profile_high").process_recording(raw, calib)
    np.testing.assert_array_equal(got.spectrogram_psd_db, exact.spectrogram_psd_db)
    np.testing.assert_array_equal(got.spectrogram_intensity,
                                  exact.spectrogram_intensity)
    a, b = got.spectrogram_psd_db, want.spectrogram_psd_db
    assert a.shape == b.shape == (nfft // 2 + 1, got.spectrogram_times.shape[0])
    m = b > -40
    assert m.sum() > 1000
    np.testing.assert_allclose(a[m], b[m], atol=1e-3)
    np.testing.assert_array_equal(a == DB_FLOOR, b == DB_FLOOR)
    assert_within_one_bf16_ulp(got.spectrogram_intensity,
                               want.spectrogram_intensity,
                               want.spectrogram_intensity > -120, 1e-3)


# --- the ValueError rules, as JAX's ---------------------------------------------


@pytest.mark.parametrize("case,nfft,kw", [
    ("unknown precision", 256, dict(psd_precision="medium")),
    ("high with recompute", 256, dict(psd_precision="high", recompute=True)),
    ("bf16 PSD with recompute", 256, dict(psd_store_dtype="bf16", recompute=True)),
    ("high past nb_pad 512", 1024, dict(psd_precision="high")),
    ("bf16 PSD past nb_pad 512", 1024, dict(psd_store_dtype="bf16")),
    ("bf16 dB past nb_pad 512", 2048, dict(db_store_dtype="bf16")),
    ("high at nb_pad 512", 1022, dict(psd_precision="high")),
    ("bf16 PSD at nb_pad 512", 1000, dict(psd_store_dtype="bf16")),
    ("highest with recompute", 256, dict(psd_precision="highest", recompute=True)),
])
def test_argument_rules_are_jax(case, nfft, kw):
    """Each argument set raises ValueError on both sides, or runs on both
    with the same shapes."""
    sig = _signal(1200, 1100)
    dtypes = {"bf16": (torch.bfloat16, jnp.bfloat16)}
    port_kw = {k: dtypes[v][0] if v in dtypes else v for k, v in kw.items()}
    jax_kw = {k: dtypes[v][1] if v in dtypes else v for k, v in kw.items()}
    try:
        want = _jax(sig, 1100, nfft, **jax_kw)
    except ValueError:
        with pytest.raises(ValueError):
            _port(sig, 1100, nfft, **port_kw)
        assert "at nb_pad 512" not in case and "highest" not in case
        return
    got = _port(sig, 1100, nfft, **port_kw)
    assert "at nb_pad 512" in case or "highest" in case
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        assert g is None or tuple(g.shape) == w.shape


# --- K2a's wrapper on device tensors (a stub library) ---------------------------


@pytest.mark.parametrize("nfft,round_bf16", [(256, False), (256, True),
                                              (512, False), (1000, True)])
def test_psd_phase1_b3_dispatch_on_device_tensors(monkeypatch, nfft, round_bf16):
    """K2a on a device tensor: one psd_phase1_b3 launch with nb_pad, t_pad,
    the valid count and the rounding flag, [nb_pad, t_pad] and
    [t_pad / 1024] float32 outputs, never the plain version; nb_pad past
    512 or not a multiple of 8 raises before any launch. spectrogram(
    psd_precision="high") launches it, then K3 (nb_pad ≤ 272) or K4b."""
    stub = _stub_library(monkeypatch)
    for name in ("psd_phase1_b3_ref", "psd_phase1_ref", "db_rescale_ref"):
        monkeypatch.setattr(stc, name, _fail_if_called)
    before = dict(_lib.LAUNCHES)
    op = StftOperator.create(**{**OP_KW, "nfft": nfft})
    align = 16 if round_bf16 else 8
    nb_pad = -(-op.num_bins // align) * align
    sig = torch.empty(3000, device="meta")
    a2 = torch.empty(2 * nb_pad, 20, device="meta")
    p, tmax = stc.psd_phase1_b3(sig, 2481, a2, nb_pad, 3072, round_bf16)
    assert p.shape == (nb_pad, 3072) and tmax.shape == (3,)
    assert p.dtype == tmax.dtype == torch.float32
    (name, args), = stub.calls
    assert name == "psd_phase1_b3_launch"
    assert (args[1], args[3], args[6], args[7], args[8]) == (
        3000, nb_pad, 3072, 2481, int(round_bf16))
    assert _launch_deltas(before) == {k: int(k == "psd_phase1_b3") for k in before}
    for bad in (520, 140):
        with pytest.raises(ValueError):
            stc.psd_phase1_b3(sig, 2481, torch.empty(2 * bad, 20, device="meta"),
                              bad, 3072)
    assert len(stub.calls) == 1
    store = torch.bfloat16 if round_bf16 else torch.float32
    psd, db, intensity = stc.spectrogram(sig, 2500, op, psd_precision="high",
                                         psd_store_dtype=store)
    assert psd.dtype == store and psd.shape == db.shape == (op.num_bins, 2981)
    phase2 = "db_rescale" if nb_pad <= stc.UNTILED_MAX_BINS else "db_rescale_tiled"
    assert [n for n, _ in stub.calls[1:]] == ["psd_phase1_b3_launch",
                                              phase2 + "_launch"]
    assert stub.calls[1][1][8] == int(round_bf16)


@pytest.mark.parametrize("nfft,kernels", [
    (256, ("psd_phase1", "db_rescale")),
    (1000, ("psd_phase1_tiled", "db_rescale_tiled")),
])
def test_bf16_psd_store_dispatch_on_device_tensors(monkeypatch, nfft, kernels):
    """The exact export with a bf16 PSD store: K2b (K4a's kernel) or K4a
    with the rounding flag set, then K3 or K4b; the psd slot bf16."""
    stub = _stub_library(monkeypatch)
    before = dict(_lib.LAUNCHES)
    op = StftOperator.create(**{**OP_KW, "nfft": nfft})
    psd, _, _ = stc.spectrogram(torch.empty(3000, device="meta"), 2500, op,
                                psd_store_dtype=torch.bfloat16)
    assert psd.dtype == torch.bfloat16
    names = [n for n, _ in stub.calls]
    assert names == ["psd_phase1_tiled_launch", kernels[1] + "_launch"]
    assert stub.calls[0][1][8] == 1  # the rounding flag
    assert _launch_deltas(before) == {k: int(k in kernels) for k in before}


def test_b3_rounding_matches_torch_bf16():
    """The plain versions' bf16 rounding is round to nearest even, as the
    kernels' __float2bfloat16_rn: ties go to the even mantissa."""
    x = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, 1.0 + 2.0 ** -9])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -6, 1.0])
    assert torch.equal(stc._bf16(x), want)
