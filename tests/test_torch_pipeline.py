"""PyTorch port: the recording path end to end vs the JAX package.

The port's RadarPipeline on the CPU (plain versions of the kernels) is held
to the JAX package's production path — the Pallas kernels in interpret
mode — and to the f64 NumPy oracle; its service to the JAX service; and
the port itself is checked to import no jax.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fmcw_radar_processing_tpu.config import (
    AlgorithmConfig,
    RadarConfig,
    default_device_config,
)
from fmcw_radar_processing_tpu.io.raw_format import write_recording
from fmcw_radar_processing_tpu.io.storage import LocalStorage
from fmcw_radar_processing_tpu.io.synth import SyntheticTarget, synthesize_recording
from fmcw_radar_processing_tpu.pipeline.recording import (
    RadarPipeline as JaxPipeline,
)
from fmcw_radar_processing_tpu.serve.handler import HandlerConfig as JaxHandlerConfig
from fmcw_radar_processing_tpu.serve.handler import RadarService as JaxService
from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline
from fmcw_radar_processing_tpu_torch.serve.cli import main as cli_main
from fmcw_radar_processing_tpu_torch.serve.handler import HandlerConfig, RadarService

from .oracle import (
    log_rescale_oracle,
    process_recording_oracle,
    psd_db_oracle,
    spectrogram_oracle,
)
from .test_pipeline import _mixed_recording, _tpu_layout
from .test_torch_ops import _snr_db, assert_within_one_bf16_ulp

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "fmcw_radar_processing_tpu_torch"
DB_FLOOR = -1000.0


def _compare_chain(got, want, cfg):
    np.testing.assert_array_equal(got.detected, want.detected)
    assert got.detected.any() and not got.detected.all()
    np.testing.assert_array_equal(got.target_range, want.target_range)
    np.testing.assert_allclose(got.target_speed, want.target_speed,
                               rtol=1e-5, atol=1e-6)
    assert _snr_db(got.waterfall, want.waterfall) > 80.0
    np.testing.assert_array_equal(got.spectrogram_times, want.spectrogram_times)
    np.testing.assert_array_equal(got.spectrogram_freqs, want.spectrogram_freqs)
    np.testing.assert_array_equal(got.spectrogram_linear_freqs,
                                  want.spectrogram_linear_freqs)


# --- (e) the production slice ---------------------------------------------


@pytest.mark.parametrize("f", [12, 24])
def test_production_slice_matches_jax(cfg, rng, f):
    """vs the JAX production path: impl pallas_profile_high + the fused
    Pallas export. Deep spectral nulls (below −120 dB) are left out: the
    JAX run's bf16x3 phase 1 carries ~2^-18 absolute PSD noise there."""
    frames, calib = _mixed_recording(cfg, rng, f=f)
    raw = _tpu_layout(frames)
    dev = default_device_config()
    port_cfg = RadarConfig.create(dev, AlgorithmConfig.production())
    pipe = RadarPipeline(port_cfg, device="cpu")
    got = pipe.process_recording(raw, calib)
    jax_cfg = RadarConfig.create(dev, AlgorithmConfig.production(stft_impl="pallas"))
    jpipe = JaxPipeline(jax_cfg, impl="pallas_profile_high")
    want = jpipe.process_recording(raw, calib)
    _compare_chain(got, want, port_cfg)
    np.testing.assert_array_equal(
        pipe.run_chain(raw, calib).detection.idx.numpy(),
        np.asarray(jpipe.run_chain(raw, calib).detection.idx))
    for name in ("spectrogram_intensity", "spectrogram_psd_db"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape
        assert_within_one_bf16_ulp(a, b, b > -120, 1e-3)
        np.testing.assert_array_equal(a == DB_FLOOR, b == DB_FLOOR)


def test_production_slice_display_band_vs_oracle(cfg, rng):
    """The production criterion (config/radar.py:167-176): ≤ 0.15 dB
    against the f64 oracle on the displayed band (above −40 dB)."""
    frames, calib = _mixed_recording(cfg, rng)
    pcfg = RadarConfig.create(default_device_config(), AlgorithmConfig.production())
    got = RadarPipeline(pcfg, device="cpu").process_recording(
        _tpu_layout(frames), calib)
    ref = process_recording_oracle(frames, calib, cfg)
    freqs, times, p = spectrogram_oracle(np.abs(ref.slow_time_signal),
                                         1.0 / cfg.derived.prt, nfft=256)
    db = psd_db_oracle(p)
    _, intensity = log_rescale_oracle(freqs, db)
    np.testing.assert_allclose(got.spectrogram_times, times, rtol=1e-6)
    assert got.spectrogram_intensity.shape == intensity.shape
    band = intensity > -40
    assert band.sum() > 100
    assert np.abs(got.spectrogram_intensity - intensity)[band].max() <= 0.15
    band_db = db > -40
    assert np.abs(got.spectrogram_psd_db - db)[band_db].max() <= 0.15


@pytest.mark.parametrize("max_targets", [2, 3])
def test_multi_target_slice_matches_jax(cfg, rng, max_targets):
    """max_num_targets > 1 takes the stable-sort (top-k) detection path."""
    frames, calib = _mixed_recording(cfg, rng, f=12)
    raw = _tpu_layout(frames)
    algo = AlgorithmConfig.production(max_num_targets=max_targets)
    got = RadarPipeline(RadarConfig.create(default_device_config(), algo),
                        device="cpu").run_chain(raw, calib)
    want = JaxPipeline(
        RadarConfig.create(default_device_config(),
                           AlgorithmConfig.production(max_num_targets=max_targets,
                                                      stft_impl="pallas")),
        impl="pallas_profile_high").run_chain(raw, calib)
    np.testing.assert_array_equal(got.detection.idx.numpy(),
                                  np.asarray(want.detection.idx))
    np.testing.assert_array_equal(got.detection.valid.numpy(),
                                  np.asarray(want.detection.valid))
    np.testing.assert_array_equal(got.range.numpy(), np.asarray(want.range))
    np.testing.assert_allclose(got.speed.numpy(), np.asarray(want.speed),
                               rtol=1e-5, atol=1e-6)


# --- (f) the fidelity profile ------------------------------------------------


@pytest.mark.parametrize("f", [12, 24, 40, 64, 100])
def test_fidelity_slice_matches_jax(cfg, rng, f):
    """Bare AlgorithmConfig: nfft = 2^nextpow2(L) (128, 256, 512, 1024 and
    2048 here — the last two take the bin-blocked export on both sides),
    float32 stores; vs the JAX fused chain + HIGHEST Pallas export, with the
    tolerances of tests/test_stft_pallas.py."""
    frames, calib = _mixed_recording(cfg, rng, f=f)
    raw = _tpu_layout(frames)
    dev = default_device_config()
    got = RadarPipeline(RadarConfig.create(dev), device="cpu").process_recording(
        raw, calib)
    want = JaxPipeline(RadarConfig.create(dev, AlgorithmConfig(stft_impl="pallas"))
                       ).process_recording(raw, calib)
    _compare_chain(got, want, cfg)
    np.testing.assert_allclose(got.waterfall, want.waterfall, rtol=1e-5, atol=1e-2)
    for name, tol in (("spectrogram_psd_db", 1e-3),
                      ("spectrogram_intensity", 2e-3)):
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape and a.dtype == np.float32
        m = b > -40
        np.testing.assert_allclose(a[m], b[m], atol=tol)
        deep = (b > -120) & ~m
        np.testing.assert_allclose(a[deep], b[deep], atol=0.2)
        np.testing.assert_array_equal(a == DB_FLOOR, b == DB_FLOOR)


# --- (g) the service --------------------------------------------------------


@pytest.fixture
def blob_root(tmp_path):
    cfg = RadarConfig.create(default_device_config())
    present = np.ones(40, bool)
    present[5:9] = False
    rec = synthesize_recording(
        cfg, 40,
        (SyntheticTarget(range_m=7.5, doppler_bin_offset=3,
                         md_phase_rad=0.8, md_rate_hz=30.0),),
        target_present=present, seed=7,
    )
    root = tmp_path / "blobs"
    store = LocalStorage(str(root))
    xml, bin_ = write_recording(str(tmp_path / "radar_data"), rec)
    store.put(xml, "radar_data.xml", "application/xml")
    store.put(bin_, "radar_data.raw.bin", "application/octet-stream")
    return str(root)


def _flat(v):
    return np.array(v, dtype=object).ravel()


def _num(v):
    return np.array([np.nan if x is None else x for x in _flat(v)], np.float64)


@pytest.mark.parametrize("profile", ["production", "fidelity"])
def test_service_payloads_match_jax(blob_root, tmp_path, profile):
    works = {}
    for name, svc_cls, cfg_cls, extra in (
        ("port", RadarService, HandlerConfig, {"device": "cpu"}),
        ("jax", JaxService, JaxHandlerConfig, {}),
    ):
        work = tmp_path / name
        work.mkdir()
        svc = svc_cls(cfg_cls(workdir=str(work), profile=profile,
                              storage_spec=f"local:{blob_root}", retries=1,
                              **extra))
        result = svc.main({"processAnimalActivity": "no"})
        assert result["status"] == "success", result
        assert [s["step"] for s in result["steps"]] == [
            "Read Files", "Radar Processing", "Upload JSON"]
        works[name] = work
    assert (works["port"] / "spectrogram.png").exists()
    for fname in ("spectrogram_data.json", "radar_data_range_fft_data.json",
                  "radar_data_range_speed_data.json", "radar_data_fft_data.json"):
        a = json.loads((works["port"] / fname).read_text())
        b = json.loads((works["jax"] / fname).read_text())
        assert a.keys() == b.keys(), fname
        for key in a:
            if isinstance(b[key], (str, int)) or b[key] is None:
                assert a[key] == b[key], (fname, key)
                continue
            va, vb = _num(a[key]), _num(b[key])
            assert np.shape(a[key]) == np.shape(b[key]), (fname, key)
            np.testing.assert_array_equal(np.isnan(va), np.isnan(vb))
            va, vb = va[~np.isnan(va)], vb[~np.isnan(vb)]
            if key == "intensity":
                m = vb > -120
                if profile == "production":
                    assert_within_one_bf16_ulp(va, vb, m, 1e-3)
                else:  # the fidelity bands of test_fidelity_slice_matches_jax
                    band = vb > -40
                    np.testing.assert_allclose(va[band], vb[band], atol=2e-3)
                    np.testing.assert_allclose(va[m], vb[m], atol=0.2)
            elif key in ("range_tx1rx1_max_abs", "magnitude"):
                np.testing.assert_allclose(va, vb, rtol=1e-5, atol=1e-2)
            elif key == "speed":
                np.testing.assert_allclose(va, vb, rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_allclose(va, vb, rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("profile", ["fidelity", "production"])
def test_service_activity_matches_jax(blob_root, tmp_path, profile):
    """A "yes" request: one batch JSON (40 frames, nfft 1024 under
    fidelity), uploaded, with the JAX service's name and content."""
    from .test_torch_fidelity import assert_intensity_close

    results = {}
    for name, svc_cls, cfg_cls, extra in (
        ("port", RadarService, HandlerConfig, {"device": "cpu"}),
        ("jax", JaxService, JaxHandlerConfig, {}),
    ):
        work = tmp_path / name
        work.mkdir()
        svc = svc_cls(cfg_cls(workdir=str(work), profile=profile,
                              storage_spec=f"local:{blob_root}", retries=1,
                              **extra))
        results[name] = svc.main({"processAnimalActivity": "yes"})
        assert results[name]["status"] == "success", results[name]
    steps = [r["steps"] for r in (results["port"], results["jax"])]
    assert steps[0][1]["artifacts"] == steps[1][1]["artifacts"] == [
        "radar_data_spectrogram_batch_1.json"]
    assert steps[0][2] == steps[1][2]  # "Uploaded 1 artifact(s) to storage."
    assert os.path.exists(os.path.join(blob_root, "radar_data_spectrogram_batch_1.json"))
    a, b = (json.loads((tmp_path / n / "radar_data_spectrogram_batch_1.json").read_text())
            for n in ("port", "jax"))
    assert a.keys() == b.keys()
    for key in a:
        if key == "intensity":
            assert_intensity_close(_num(a[key]).reshape(np.shape(a[key])),
                                   _num(b[key]).reshape(np.shape(b[key])), profile)
        elif key in ("time", "frequency"):
            np.testing.assert_array_equal(a[key], b[key])
        else:
            assert a[key] == b[key], key


def test_cli_synth_process_serve_once(tmp_path):
    base = str(tmp_path / "rec")
    assert cli_main(["synth", base, "--frames", "24", "--target", "7.5:3:4",
                     "--target", "16.9:-2:2"]) == 0
    out = tmp_path / "out"
    assert cli_main(["process", base, "--device", "cpu", "--algo", "production",
                     "--output-dir", str(out), "--compact-json",
                     "--profile"]) == 0
    speed = json.loads((out / "rec_range_speed_data.json").read_text())
    assert {v for v in _flat(speed["range"]) if v is not None} == {7.5}
    assert (out / "spectrogram.png").exists()
    store = LocalStorage(str(tmp_path / "blobs"))
    store.put(base + ".xml", "radar_data.xml")
    store.put(base + ".raw.bin", "radar_data.raw.bin")
    work = tmp_path / "work"
    work.mkdir()
    assert cli_main(["serve-once", "--device", "cpu", "--profile", "production",
                     "--workdir", str(work),
                     "--storage", f"local:{tmp_path / 'blobs'}"]) == 0
    assert (work / "radar_data_fft_data.json").exists()


# --- (h) no jax in the port ---------------------------------------------------

def _port_files():
    """The port's modules and the test modules written for the card alone,
    which its machine must import without Flax or JAX."""
    return sorted(PORT.rglob("*.py")) + [
        REPO / "tests" / name for name in ("test_torch_card_models.py",
                                           "test_torch_card_paths.py")]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    loaders = set()  # modules this file takes load_recording_for_chain from
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [(a.name, None) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [(node.module or "", {a.name for a in node.names})]
        else:
            continue
        for mod, names in mods:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "flax", "optax"), mod
            # Nothing of the JAX package either, not even its jax-free
            # modules: the port keeps its own config, io and jsonio.
            assert mod.split(".")[0] != "fmcw_radar_processing_tpu", (
                f"{path.name} imports {mod}")
            if names and "load_recording_for_chain" in names:
                loaders.add(mod)
    # The JAX package's loader imports jax; the port's loader is its own
    # (io/raw_format.py, over its own native reader), and every file that
    # uses it takes it from there.
    assert loaders <= {"fmcw_radar_processing_tpu_torch.io.raw_format"}, loaders
    if "load_recording_for_chain" in path.read_text() and not loaders:
        assert path.relative_to(REPO).as_posix() in (
            "fmcw_radar_processing_tpu_torch/io/raw_format.py",
            "fmcw_radar_processing_tpu_torch/io/native_loader.py"), path.name


_NO_JAX_SCRIPT = r"""
import sys
for name in [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))]:
    del sys.modules[name]

class _BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is blocked: " + name)
        return None

sys.meta_path.insert(0, _BlockJax())
import numpy as np
from fmcw_radar_processing_tpu.config import AlgorithmConfig, RadarConfig, default_device_config
from fmcw_radar_processing_tpu.io.synth import SyntheticTarget, synthesize_recording
import fmcw_radar_processing_tpu_torch.serve.cli
import fmcw_radar_processing_tpu_torch.serve.dashboard
import fmcw_radar_processing_tpu_torch.serve.handler
import fmcw_radar_processing_tpu_torch.serve.http_service
import fmcw_radar_processing_tpu_torch.models.infer
from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline
from fmcw_radar_processing_tpu_torch.pipeline.streaming import StreamingProcessor
from fmcw_radar_processing_tpu_torch.utils.cplx import to_pair

cfg = RadarConfig.create(default_device_config(), AlgorithmConfig.production())
present = np.ones(24, bool)
present[::4] = False
tgt = SyntheticTarget(range_m=7.5, doppler_bin_offset=3)
rec = synthesize_recording(cfg, 24, (tgt,), seed=1, target_present=present)
out = RadarPipeline(cfg, device="cpu").process_recording(
    to_pair(rec.rx1()), to_pair(rec.calib_vector(0, cfg.nts)))
assert np.array_equal(out.detected, present)
assert np.all(out.target_range[0, present] == np.float32(7.5))
assert np.isfinite(out.spectrogram_intensity).all()
win = StreamingProcessor(cfg, 1, 24, "cpu").process_window(
    to_pair(rec.rx1())[None], to_pair(rec.calib_vector(0, cfg.nts))[None])
assert int(win.col_count[0]) == int(present.sum()) * cfg.pn - 19
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
print("no-jax ok")
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no-jax ok" in proc.stdout
