"""PyTorch port: the per-stage SNR ladder (tools/snr_ladder.py) and its
float64 oracle (tools/oracle.py).

The port's oracle is held to the repository's test oracle function by
function (float64, rtol 1e-12). The CPU ladder meets every assertion of
the JAX ladder's structure test (tests/test_snr_ladder.py) and agrees with
JAX's tool at each precision: equal band fractions; every SNR that JAX
reads below 100 dB within 3 dB once the slow-time recompute is as exact
as XLA:CPU's (the full-map and floor-band figures are float32
cancellation at spectral nulls, which moves with summation order); every
one at or above 100 dB also at or above 100 dB here. With the
card's pass semantics forced on the CPU, the 256-frame ladder holds the
shape of the TPU's: "default" stage 1 near 66 dB, "high" above 110 dB,
stages 1-3 rising with the pass count. The test marked ``cuda`` holds the
three rungs to that shape on the card itself.
"""

import json

import numpy as np
import pytest
import torch

from fmcw_radar_processing_tpu.config import AlgorithmConfig as JAlgorithmConfig
from fmcw_radar_processing_tpu.config import RadarConfig as JRadarConfig
from fmcw_radar_processing_tpu.config import default_device_config as jdefault
from fmcw_radar_processing_tpu_torch.config import (
    AlgorithmConfig,
    RadarConfig,
    default_device_config,
)
from fmcw_radar_processing_tpu_torch.dsp import fast_time as tft
from fmcw_radar_processing_tpu_torch.tools import oracle as toracle
from fmcw_radar_processing_tpu_torch.tools import snr_ladder
from fmcw_radar_processing_tpu_torch.utils import cplx as tcplx
from tests import oracle as joracle
from tools.snr_ladder import build_ladder as jax_build_ladder

from .test_pipeline import _mixed_recording

PRECISIONS = ("default", "high", "highest")


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread, so that the tests do not oversubscribe the cores
    the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the oracle --------------------------------------------------------------


def _oracle_cases():
    """name → (port call, repository oracle call), on seeded inputs."""
    tcfg = RadarConfig.create(default_device_config(), AlgorithmConfig())
    jcfg = JRadarConfig.create(jdefault(), JAlgorithmConfig())
    rng = np.random.default_rng(13)
    frames, calib = _mixed_recording(jcfg, rng, f=6)
    frames = frames.astype(np.complex128)
    calib = calib.astype(np.complex128)
    rf = joracle.fast_time_oracle(frames[1], calib, jcfg)
    profile = joracle.integrate_profile_oracle(rf)
    idx, _ = joracle.search_peak_oracle(profile, jcfg)
    rd = joracle.slow_time_oracle(rf, idx, jcfg)
    iq = np.abs(rng.standard_normal(300)) + 0.5
    freqs, _, p = joracle.spectrogram_oracle(iq, 1250.0, nfft=256)
    db = joracle.psd_db_oracle(p)

    def both(name, *args):
        return (lambda: getattr(toracle, name)(*[tcfg if a is jcfg else a
                                                 for a in args]),
                lambda: getattr(joracle, name)(*args))

    return {
        "fast_time_oracle": both("fast_time_oracle", frames[1], calib, jcfg),
        "integrate_profile_oracle": both("integrate_profile_oracle", rf),
        "search_peak_oracle": both("search_peak_oracle", profile, jcfg),
        "slow_time_oracle": both("slow_time_oracle", rf, idx, jcfg),
        "doppler_extract_oracle": both("doppler_extract_oracle", rd, idx, jcfg),
        "process_recording_oracle": both("process_recording_oracle", frames,
                                         calib, jcfg),
        "spectrogram_oracle": both("spectrogram_oracle", iq, 1250.0),
        "psd_db_oracle": both("psd_db_oracle", p),
        "log_rescale_oracle": both("log_rescale_oracle", freqs, db),
    }


def _leaves(x):
    if hasattr(x, "__dataclass_fields__"):
        return [v for k in x.__dataclass_fields__ for v in _leaves(getattr(x, k))]
    if isinstance(x, tuple):
        return [v for e in x for v in _leaves(e)]
    return [np.asarray(x)]


ORACLE_FUNCTIONS = ("fast_time_oracle", "integrate_profile_oracle",
                    "search_peak_oracle", "slow_time_oracle",
                    "doppler_extract_oracle", "process_recording_oracle",
                    "spectrogram_oracle", "psd_db_oracle", "log_rescale_oracle")


@pytest.mark.parametrize("name", ORACLE_FUNCTIONS)
def test_oracle_matches_the_repository_oracle(name):
    """Every function the ladder needs, on seeded inputs: float64 arrays
    within rtol 1e-12, -inf and NaN where the repository's oracle has
    them."""
    cases = _oracle_cases()
    assert set(cases) == set(ORACLE_FUNCTIONS)
    port, repo = cases[name]
    got, want = _leaves(port()), _leaves(repo())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)


# --- the ladder on the CPU ---------------------------------------------------


def _snrs(ladder: dict):
    """Every SNR figure of a ladder by its path, and every band fraction."""
    snrs, fractions = {}, {}
    for key, value in ladder.items():
        if key.endswith("_snr_db"):
            snrs[key] = value
        if key.endswith("_bands"):
            for band, stats in value.items():
                snrs[f"{key}.{band}"] = stats["snr_db"]
                fractions[f"{key}.{band}"] = stats["fraction_of_bins"]
    return snrs, fractions


def test_ladder_structure():
    """tests/test_snr_ladder.py::test_ladder_structure's assertions on the
    port's ladder (frames 64, nfft 256, seed 3, the CPU)."""
    lad = snr_ladder.build_ladder(frames=64, nfft=256, seed=3, device="cpu")
    assert lad["device_kind"] == "cpu" and lad["matmul_precision"] == "highest"

    assert lad["1_slow_time_snr_db"] > 110, lad
    assert lad["3_psd_linear_snr_db"] > 110, lad

    disp = lad["intensity_bands"]["display_band_ge_-40dB"]
    assert disp["snr_db"] > 90, lad
    assert disp["max_abs_err_db"] < 0.01, lad
    assert lad["psd_db_bands"]["ge_-120dB"]["max_abs_err_db"] < 0.05, lad

    full = lad["4_psd_db_full_snr_db"]
    banded = lad["psd_db_bands"]["ge_-120dB"]["snr_db"]
    assert banded > full, lad
    assert banded > 100, lad

    rel = lad["psd_linear_median_rel_err_by_band"]
    assert rel["floor_lt_-120dB"] > 10 * rel["ge_-40dB"], rel


def _hold_to_jax(got: dict, want: dict, slack: float) -> None:
    """Equal keys, columns and band fractions; each SNR below 100 dB in JAX
    within 3 dB + ``slack`` here, each at or above 100 dB also at or above
    100 dB here."""
    assert set(got) == set(want)
    assert got["stft_columns"] == want["stft_columns"]
    assert got["matmul_precision"] == want["matmul_precision"]
    (g_snr, g_frac), (w_snr, w_frac) = _snrs(got), _snrs(want)
    assert g_frac == w_frac
    assert set(g_snr) == set(w_snr)
    for key, w in w_snr.items():
        if w >= 100.0:
            assert g_snr[key] >= 100.0, (key, g_snr[key], w)
        else:
            assert abs(g_snr[key] - w) <= 3.0 + slack, (key, g_snr[key], w, slack)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_ladder_matches_jax_tool(precision, monkeypatch):
    """Against the JAX package's tool with the same arguments, both on the
    CPU. The full-map and floor-band figures (all JAX reads below 100 dB)
    follow the slow-time signal's error dB for dB: on the same float32
    operands MKL's batched product of PackedFastTime.rf_at_bins sums to
    about 134 dB, XLA:CPU's einsum to about 139-143 dB. So, first, with the
    port's recompute rounded from an exact float64 product (what the
    stages after it are held to): each such figure within 3 dB of JAX's.
    Then the port as it runs: within 3 dB plus its magnitude-stage
    shortfall against JAX's."""
    want = jax_build_ladder(frames=64, nfft=256, seed=3, precision=precision)
    real = tft.precision_matmul
    with monkeypatch.context() as m:
        m.setattr(tft, "precision_matmul", lambda a, b, *args, **kw: torch.matmul(
            a.double(), b.double()).float() if a.dim() == 3 else real(a, b, *args, **kw))
        exact_rows = snr_ladder.build_ladder(frames=64, nfft=256, seed=3,
                                             precision=precision, device="cpu")
    _hold_to_jax(exact_rows, want, 0.0)
    got = snr_ladder.build_ladder(frames=64, nfft=256, seed=3,
                                  precision=precision, device="cpu")
    assert got["1_slow_time_snr_db"] >= 130.0, got
    shortfall = max(0.0, want["2_magnitude_snr_db"] - got["2_magnitude_snr_db"])
    _hold_to_jax(got, want, shortfall)


@pytest.fixture(scope="module")
def forced_ladders():
    """The 256-frame ladder (frames 256, nfft 256, seed 0: the shape of the
    TPU's SNR_LADDER.json) at each precision with the card's pass
    semantics forced on the CPU."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tcplx, "takes_mxu_passes", lambda t: True)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {p: snr_ladder.build_ladder(frames=256, nfft=256, seed=0,
                                           precision=p, device="cpu")
                for p in PRECISIONS}
    finally:
        torch.set_num_threads(n)
        mp.undo()


def test_forced_default_rung(forced_ladders):
    """One bf16 pass: stage 1 within 60-72 dB (the CPU emulation of the
    JAX package at one pass gives 66.1, the v5e's record 66.1), the
    display band's intensity error within 0.2-0.8 dB."""
    lad = forced_ladders["default"]
    assert 60.0 <= lad["1_slow_time_snr_db"] <= 72.0, lad
    err = lad["intensity_bands"]["display_band_ge_-40dB"]["max_abs_err_db"]
    assert 0.2 <= err <= 0.8, lad


def test_forced_high_rung(forced_ladders):
    """Three passes: stage 1 at least 110 dB, the display band within
    0.005 dB."""
    lad = forced_ladders["high"]
    assert lad["1_slow_time_snr_db"] >= 110.0, lad
    assert lad["intensity_bands"]["display_band_ge_-40dB"]["max_abs_err_db"] <= 0.005


@pytest.mark.parametrize("stage", ["1_slow_time_snr_db", "2_magnitude_snr_db",
                                   "3_psd_linear_snr_db"])
def test_forced_stages_rise_with_the_pass_count(forced_ladders, stage):
    d, h, x = (forced_ladders[p][stage] for p in PRECISIONS)
    assert d < h < x, (stage, d, h, x)


def test_forced_detections_hold_at_one_pass(forced_ladders):
    """build_ladder's count == len(oracle) assertion held at every rung
    (the ladder would have raised); the same STFT columns at each."""
    cols = {forced_ladders[p]["stft_columns"] for p in PRECISIONS}
    assert len(cols) == 1


# --- the command line --------------------------------------------------------


def test_main_writes_three_rungs(tmp_path, monkeypatch):
    """``main --device cpu --out PATH`` writes one rung per precision (at 64
    frames here, through the same build_ladder)."""
    real = snr_ladder.build_ladder
    monkeypatch.setattr(snr_ladder, "build_ladder",
                        lambda **kw: real(frames=64, **kw))
    out = tmp_path / "ladder.json"
    assert snr_ladder.main(["--device", "cpu", "--out", str(out)]) == 0
    data = json.loads(out.read_text())
    assert list(data) == list(PRECISIONS)
    assert all(data[p]["matmul_precision"] == p and data[p]["frames"] == 64
               for p in PRECISIONS)


def test_ladder_runs_on_the_card_unless_asked(monkeypatch):
    """The ladder defaults to "cuda" and raises without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        snr_ladder.build_ladder(frames=64)
    with pytest.raises(RuntimeError, match="cuda"):
        snr_ladder.main(["--out", "unused.json"])



# --- the ladder on the card ---------------------------------------------------


@pytest.mark.cuda
def test_ladder_on_card():
    """The ladder at the TPU record's shape (256 frames, nfft 256, seed 0)
    on the card, where the precisions take their pass semantics: stages
    1-3 rise strictly with the pass count; at "highest" each is at least
    130 dB and the intensity's display band within 0.001 dB; at "high"
    that band within 0.005 dB; at "default" stage 1 within 60-72 dB (the
    TPU's record: 66.1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tcplx.pin_f32_matmul()
    lads = {p: snr_ladder.build_ladder(frames=256, nfft=256, seed=0, precision=p,
                                       device="cuda") for p in PRECISIONS}
    stages = ("1_slow_time_snr_db", "2_magnitude_snr_db", "3_psd_linear_snr_db")
    for st in stages:
        assert lads["default"][st] < lads["high"][st] < lads["highest"][st], st
        assert lads["highest"][st] >= 130.0, st

    def display(p):
        return lads[p]["intensity_bands"]["display_band_ge_-40dB"]["max_abs_err_db"]

    assert display("highest") <= 0.001 and display("high") <= 0.005
    assert 60.0 <= lads["default"]["1_slow_time_snr_db"] <= 72.0
