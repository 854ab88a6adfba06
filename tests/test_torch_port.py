"""PyTorch port: its own config, I/O and JSON modules against the JAX
package's, its independence from the JAX package, the card as the default
device of its entry points, and "auto" resolved by device.

The port keeps copies of the JAX package's jax-free modules (config, io,
utils.jsonio): these tests hold the copies to the originals field for
field, array for array and byte for byte.
"""

import dataclasses
import inspect
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from fmcw_radar_processing_tpu import config as jconfig
from fmcw_radar_processing_tpu.config import loaders as jloaders
from fmcw_radar_processing_tpu.io import raw_format as jraw
from fmcw_radar_processing_tpu.io import synth as jsynth
from fmcw_radar_processing_tpu.utils import jsonio as jjson
from fmcw_radar_processing_tpu.utils.cplx import to_pair as jto_pair
from fmcw_radar_processing_tpu_torch import config as tconfig
from fmcw_radar_processing_tpu_torch.config import loaders as tloaders
from fmcw_radar_processing_tpu_torch.io import raw_format as traw
from fmcw_radar_processing_tpu_torch.io import storage as tstorage
from fmcw_radar_processing_tpu_torch.io import synth as tsynth
from fmcw_radar_processing_tpu_torch.utils import jsonio as tjson

REPO = Path(__file__).resolve().parent.parent


def _algos(mod):
    return {
        "production": mod.AlgorithmConfig.production(),
        "fidelity": mod.AlgorithmConfig(),
        "production_t3": mod.AlgorithmConfig.production(max_num_targets=3,
                                                        stft_nfft=512),
    }


# --- the port imports nothing of the JAX package -----------------------------

_IMPORT_SCRIPT = r"""
import importlib, pkgutil, sys
import fmcw_radar_processing_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "fmcw_radar_processing_tpu"))
print("modules", len(names), "bad", bad)
assert len(names) > 30 and not bad
new = {port.__name__ + "." + m for m in (
    "entry", "io.native_loader", "parallel", "parallel.mesh", "parallel.multihost",
    "parallel.sharded_chain", "parallel.sharded_stft", "parallel.tp_chain",
    "parallel.pp_chain", "parallel.sp_recording", "tools", "tools.oracle",
    "tools.snr_ladder")}
assert new <= set(names), new - set(names)
import torch.distributed
assert not torch.distributed.is_initialized()  # importing starts no group
"""


def test_port_loads_no_jax_package_module():
    """Every submodule of the port (parallel/, io/native_loader.py,
    entry.py and tools/ among them) imported in a fresh process:
    sys.modules then holds no jax and no fmcw_radar_processing_tpu module,
    and no process group was started."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "bad []" in proc.stdout


# --- config ------------------------------------------------------------------


@pytest.mark.parametrize("profile", ["production", "fidelity", "production_t3"])
def test_config_equals_jax_field_by_field(profile):
    """RadarConfig.create(default_device_config(), ...) of both packages:
    the same fields, values and types, derived included, and the same
    canonical JSON."""
    got = tconfig.RadarConfig.create(tconfig.default_device_config(),
                                     _algos(tconfig)[profile])
    want = jconfig.RadarConfig.create(jconfig.default_device_config(),
                                      _algos(jconfig)[profile])
    for part in ("device", "algorithm", "derived"):
        g, w = getattr(got, part), getattr(want, part)
        assert [f.name for f in dataclasses.fields(g)] == [
            f.name for f in dataclasses.fields(w)]
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            assert type(a) is type(b) and a == b, (part, f.name, a, b)
    assert got.to_json() == want.to_json()
    assert (got.nts, got.pn, got.zero_doppler_bin) == (
        want.nts, want.pn, want.zero_doppler_bin)
    assert got.derived.speed_axis(16) == want.derived.speed_axis(16)
    assert got.derived.range_axis(256) == want.derived.range_axis(256)


def test_config_defaults_and_helpers_equal_jax():
    """Every AlgorithmConfig default, next_pow2 and the XML round trip."""
    assert dataclasses.asdict(tconfig.AlgorithmConfig()) == dataclasses.asdict(
        jconfig.AlgorithmConfig())
    assert [tconfig.next_pow2(n) for n in range(0, 5000, 7)] == [
        jconfig.radar.next_pow2(n) for n in range(0, 5000, 7)]
    dev = jconfig.default_device_config()
    xml = jloaders.device_config_to_xml(dev)
    assert tloaders.device_config_to_xml(tconfig.default_device_config()) == xml
    assert dataclasses.asdict(tloaders.device_config_from_xml(xml)) == \
        dataclasses.asdict(dev)
    with pytest.raises(ValueError, match="numChirpsPerFrame"):
        tloaders.device_config_from_xml(xml.replace("numChirpsPerFrame", "x"))


# --- io ------------------------------------------------------------------------


def _targets(mod):
    return (mod.SyntheticTarget(range_m=7.5, doppler_bin_offset=3),
            mod.SyntheticTarget(range_m=16.9, doppler_bin_offset=-2,
                                amplitude=2.0, md_phase_rad=0.4,
                                md_rate_hz=1.5))


@pytest.mark.parametrize("seed", [0, 7])
def test_synthesize_recording_equals_jax(seed):
    present = np.random.default_rng(seed).random(20) > 0.2
    got = tsynth.synthesize_recording(
        tconfig.RadarConfig.create(tconfig.default_device_config()), 20,
        _targets(tsynth), seed=seed, target_present=present)
    want = jsynth.synthesize_recording(
        jconfig.RadarConfig.create(jconfig.default_device_config()), 20,
        _targets(jsynth), seed=seed, target_present=present)
    for name in ("frames", "calib"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(got.device) == dataclasses.asdict(want.device)
    cfg = tconfig.RadarConfig.create(tconfig.default_device_config())
    jcfg = jconfig.RadarConfig.create(jconfig.default_device_config())
    for t, j in zip(_targets(tsynth), _targets(jsynth)):
        assert (t.range_bin(cfg), t.reported_speed(cfg)) == (
            j.range_bin(jcfg), j.reported_speed(jcfg))
    np.testing.assert_array_equal(got.rx1_pair(), jto_pair(want.rx1()))
    np.testing.assert_array_equal(got.calib_pair(0, cfg.nts),
                                  jto_pair(want.calib_vector(0, jcfg.nts)))


def test_recording_round_trip_equals_jax(tmp_path):
    """write_recording → read_recording in both packages, crosswise: the
    files are byte-identical and every read gives the same arrays."""
    rec = jsynth.synthesize_recording(
        jconfig.RadarConfig.create(jconfig.default_device_config()), 6,
        _targets(jsynth), seed=3)
    port_rec = traw.RawRecording(frames=rec.frames, calib=rec.calib,
                                 device=tconfig.default_device_config())
    jpaths = jraw.write_recording(str(tmp_path / "j"), rec)
    tpaths = traw.write_recording(str(tmp_path / "t"), port_rec)
    for a, b in zip(tpaths, jpaths):
        assert Path(a).read_bytes() == Path(b).read_bytes()
    for base in ("j", "t"):
        got = traw.read_recording(str(tmp_path / base))
        want = jraw.read_recording(str(tmp_path / base))
        np.testing.assert_array_equal(got.frames, want.frames)
        np.testing.assert_array_equal(got.calib, want.calib)
        np.testing.assert_array_equal(got.calib_vector(0, 64),
                                      want.calib_vector(0, 64))
        assert dataclasses.asdict(got.device) == dataclasses.asdict(want.device)
    real = traw.RawRecording(frames=rec.frames.real.copy(), calib=rec.calib)
    traw.write_raw_bin(str(tmp_path / "r.raw.bin"), real)
    back = jraw.read_raw_bin(str(tmp_path / "r.raw.bin"))
    assert back.frames.dtype == np.float32
    np.testing.assert_array_equal(back.frames, real.frames)


def test_local_storage_and_spec(tmp_path):
    store = tstorage.get_storage(f"local:{tmp_path / 'blobs'}")
    src = tmp_path / "a.json"
    src.write_text("{}")
    store.put(str(src), "x/a.json", "application/json")
    store.get("x/a.json", str(tmp_path / "b.json"))
    assert (tmp_path / "b.json").read_text() == "{}"
    with pytest.raises(FileNotFoundError):
        store.get("missing", str(tmp_path / "c"))
    with pytest.raises(ValueError, match="unknown storage spec"):
        tstorage.get_storage("s3://nowhere")


# --- jsonio ----------------------------------------------------------------------


@pytest.mark.parametrize("pretty", [True, False])
def test_write_json_of_payloads_byte_identical(tmp_path, pretty):
    """The four payloads of one recording (the port's CPU pipeline) written
    by both packages' write_json: the same bytes."""
    from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline

    cfg = tconfig.RadarConfig.create(tconfig.default_device_config())
    rec = tsynth.synthesize_recording(cfg, 48, _targets(tsynth), seed=5)
    out = RadarPipeline(cfg, device="cpu").process_recording(
        rec.rx1_pair(), rec.calib_pair(0, cfg.nts))
    assert len(out.payloads) == 4
    for name, payload in out.payloads.items():
        a = tjson.write_json(str(tmp_path / f"t_{name}"), payload, pretty=pretty)
        b = jjson.write_json(str(tmp_path / f"j_{name}"), payload, pretty=pretty)
        assert Path(a).read_bytes() == Path(b).read_bytes(), name
    odd = {"m": np.array([[1.5, np.nan], [np.inf, -0.0]] * 300, np.float32),
           "v": np.arange(600, dtype=np.float64) / 7, "n": None, "s": "x",
           "nested": {"a": [1, 2.5, np.float32(3)]}, "b": np.bool_(True)}
    assert tjson.dumps_matlab(odd, pretty) == jjson.dumps_matlab(odd, pretty)


# --- entry points run on the card by default ---------------------------------


def _entry_points(tmp_path):
    from fmcw_radar_processing_tpu_torch.models.dataset_gen import (
        generate_micro_doppler_dataset,
    )
    from fmcw_radar_processing_tpu_torch.models.experiment import (
        ExperimentConfig,
        run_classifier_experiment,
    )
    from fmcw_radar_processing_tpu_torch.models.infer import (
        SpectrogramClassifier,
        export_classifier,
    )
    from fmcw_radar_processing_tpu_torch.models.params import state_dict_to_flax
    from fmcw_radar_processing_tpu_torch.models.robustness import run_robustness_sweep
    from fmcw_radar_processing_tpu_torch.models.train import Trainer
    from fmcw_radar_processing_tpu_torch.models.vgg import build_model
    from fmcw_radar_processing_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
    from fmcw_radar_processing_tpu_torch.parallel.pp_chain import (
        STAGE_AXIS,
        make_pp_frame_chain,
    )
    from fmcw_radar_processing_tpu_torch.parallel.sharded_chain import (
        make_sharded_frame_chain,
    )
    from fmcw_radar_processing_tpu_torch.parallel.sp_recording import (
        ShardedRecordingPipeline,
    )
    from fmcw_radar_processing_tpu_torch.parallel.tp_chain import make_tp_frame_chain
    from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import make_frame_chain
    from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline
    from fmcw_radar_processing_tpu_torch.pipeline.streaming import StreamingProcessor
    from fmcw_radar_processing_tpu_torch.entry import dryrun_multichip, entry
    from fmcw_radar_processing_tpu_torch.serve.cli import main as cli_main

    shape = (32, 32, 3)
    cfg = tconfig.RadarConfig.create(tconfig.default_device_config())
    sp_cfg = tconfig.RadarConfig.create(tconfig.default_device_config(),
                                        tconfig.AlgorithmConfig(stft_nfft=256))
    mesh = make_mesh()  # one rank: no process group
    # A (data 1, stage 2) mesh as one rank of two sees it; the chain's
    # builder runs no collective.
    pp_mesh = types.SimpleNamespace(axis_names=(DATA_AXIS, STAGE_AXIS),
                                    shape={DATA_AXIS: 1, STAGE_AXIS: 2},
                                    index=lambda axis: 0)
    params = state_dict_to_flax(build_model("small", shape, "cpu").state_dict())
    art = export_classifier(str(tmp_path / "art"), "small", params, shape,
                            ("calf", "human"))
    tiny = ExperimentConfig(images_per_class=7, frames_per_recording=16,
                            image_size=(16, 16), epochs=1, batch_size=4,
                            render_size=(40, 30))
    sweep = dict(train_images_per_class=1, test_images_per_class=1,
                 frames_per_recording=16, epochs=1, image_size=(16, 16),
                 render_size=(40, 30), snr_grid_db=(20.0,), extra_conditions=False)
    data = tmp_path / "images"
    from PIL import Image

    for i, cname in enumerate(("calf", "human")):
        (data / cname).mkdir(parents=True)
        Image.new("RGB", (16, 16), (40 * i, 0, 0)).save(data / cname / "a.png")
    return {
        "RadarPipeline": lambda: RadarPipeline(cfg),
        "make_frame_chain": lambda: make_frame_chain(cfg),
        "SpectrogramClassifier": lambda: SpectrogramClassifier(
            "small", params, shape, ("calf", "human")),
        "SpectrogramClassifier.load": lambda: SpectrogramClassifier.load(art),
        "build_model": lambda: build_model("small", shape),
        "Trainer": lambda: Trainer("small", input_shape=shape),
        "generate_micro_doppler_dataset": lambda: generate_micro_doppler_dataset(
            str(tmp_path / "gen_cuda"), images_per_class=1, frames_per_recording=16),
        "run_classifier_experiment": lambda: run_classifier_experiment(
            str(tmp_path / "exp_cuda"), tiny),
        "run_robustness_sweep": lambda: run_robustness_sweep(
            str(tmp_path / "rob_cuda"), **sweep),
        "cli train": lambda: cli_main(["train", "--data-dir", str(data)]),
        "make_sharded_frame_chain": lambda: make_sharded_frame_chain(cfg, mesh),
        "ShardedRecordingPipeline": lambda: ShardedRecordingPipeline(sp_cfg, mesh),
        "make_tp_frame_chain": lambda: make_tp_frame_chain(cfg, mesh),
        "make_pp_frame_chain": lambda: make_pp_frame_chain(cfg, pp_mesh),
        "StreamingProcessor(mesh=...)": lambda: StreamingProcessor(cfg, 2, 4,
                                                                   mesh=mesh),
        "Trainer(mesh=...)": lambda: Trainer("small", input_shape=shape, mesh=mesh),
        "dryrun_multichip": lambda: dryrun_multichip(1, paths=("dp",)),
        "entry": lambda: entry(),
    }, {
        "RadarPipeline": lambda: RadarPipeline(cfg, device="cpu"),
        "make_frame_chain": lambda: make_frame_chain(cfg, "cpu"),
        "SpectrogramClassifier": lambda: SpectrogramClassifier(
            "small", params, shape, ("calf", "human"), "cpu"),
        "SpectrogramClassifier.load": lambda: SpectrogramClassifier.load(
            art, "cpu"),
        "build_model": lambda: build_model("small", shape, "cpu"),
        "Trainer": lambda: Trainer("small", input_shape=shape, device="cpu"),
        "generate_micro_doppler_dataset": lambda: generate_micro_doppler_dataset(
            str(tmp_path / "gen"), images_per_class=1, frames_per_recording=16,
            image_size=(40, 30), device="cpu"),
        "run_classifier_experiment": lambda: run_classifier_experiment(
            str(tmp_path / "exp"), tiny, device="cpu"),
        "run_robustness_sweep": lambda: run_robustness_sweep(
            str(tmp_path / "rob"), **sweep, device="cpu"),
        "cli train": lambda: cli_main(["train", "--data-dir", str(data),
                                       "--epochs", "1", "--device", "cpu"]) == 0 or None,
        "make_sharded_frame_chain": lambda: make_sharded_frame_chain(cfg, mesh, "cpu"),
        "ShardedRecordingPipeline": lambda: ShardedRecordingPipeline(
            sp_cfg, mesh, device="cpu"),
        "make_tp_frame_chain": lambda: make_tp_frame_chain(cfg, mesh, "cpu"),
        "make_pp_frame_chain": lambda: make_pp_frame_chain(cfg, pp_mesh, device="cpu"),
        "StreamingProcessor(mesh=...)": lambda: StreamingProcessor(
            cfg, 2, 4, "cpu", mesh=mesh),
        "Trainer(mesh=...)": lambda: Trainer("small", input_shape=shape,
                                             device="cpu", mesh=mesh),
        "dryrun_multichip": lambda: dryrun_multichip(1, device="cpu", frames=8,
                                                     paths=("dp",)),
        "entry": lambda: entry("cpu"),
    }


@pytest.mark.parametrize("name", ["RadarPipeline", "make_frame_chain",
                                  "SpectrogramClassifier",
                                  "SpectrogramClassifier.load", "build_model",
                                  "Trainer", "generate_micro_doppler_dataset",
                                  "run_classifier_experiment",
                                  "run_robustness_sweep", "cli train",
                                  "make_sharded_frame_chain",
                                  "ShardedRecordingPipeline",
                                  "make_tp_frame_chain", "make_pp_frame_chain",
                                  "StreamingProcessor(mesh=...)",
                                  "Trainer(mesh=...)", "dryrun_multichip",
                                  "entry"])
def test_entry_point_defaults_to_the_card(monkeypatch, tmp_path, name):
    """With no device given an entry point takes "cuda": without a card it
    raises RuntimeError instead of running on the CPU; "cpu" must be asked
    for."""
    default, cpu = _entry_points(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        default[name]()
    assert cpu[name]() is not None


@pytest.mark.parametrize("fn", ["PackedFastTime.create",
                                "FastTimeOperator.create",
                                "SlowTimeOperator.create", "blocked_weight"])
def test_internal_builders_take_device_without_default(fn):
    from fmcw_radar_processing_tpu_torch.dsp.fast_time import (
        FastTimeOperator,
        PackedFastTime,
    )
    from fmcw_radar_processing_tpu_torch.dsp.slow_time import SlowTimeOperator
    from fmcw_radar_processing_tpu_torch.ops.fast_time_cuda import blocked_weight

    obj = {"PackedFastTime.create": PackedFastTime.create,
           "FastTimeOperator.create": FastTimeOperator.create,
           "SlowTimeOperator.create": SlowTimeOperator.create,
           "blocked_weight": blocked_weight}[fn]
    param = inspect.signature(obj).parameters["device"]
    assert param.default is inspect.Parameter.empty


@pytest.mark.parametrize("impl,device,want", [
    ("auto", "cuda", "pallas_profile_high"),
    ("auto", torch.device("cuda", 0), "pallas_profile_high"),
    ("auto", "cpu", "pallas_profile"),
    ("pallas_profile_high", "cpu", "pallas_profile_high"),
    ("pallas_profile", "cuda", "pallas_profile"),
    ("pallas", "cpu", "pallas"),
    ("pallas_profile_bf16", "cuda", "pallas_profile_bf16"),
    ("fused", "cuda", "fused"),
    ("xla", "cpu", "xla"),
    ("fused_bf16", "cpu", "fused_bf16"),
])
def test_resolve_impl_auto_by_device(impl, device, want):
    """As the JAX package's resolve_impl by backend: the bf16x3 chain on
    the accelerator, an exact one elsewhere; explicit impls stay, each of
    the JAX package's seven."""
    from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import resolve_impl

    assert resolve_impl(impl, device) == want
