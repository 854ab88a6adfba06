"""PyTorch port: the sharded recording export (parallel/sp_recording.py).

Spawned gloo ranks on the CPU (tests/_torch_parallel_ranks.py) at world
sizes 1, 2 and 4 run ``ShardedRecordingPipeline.process``; its gathered
outputs are held to the JAX package's ``ShardedRecordingPipeline`` on a
mesh of the same size (the suite's virtual devices) and to the port's
single-process ``RadarPipeline``, with test_sp_recording.py:50-67's
bounds: detections exact, waterfall rtol 3e-4 / atol 0.05, ranges rtol
1e-5, speeds rtol 1e-4 / atol 1e-6, intensity within 2e-3 dB where the
reference is above −120 dB (against JAX, the port's package-to-package
dB bound: see ``_assert_recording``). The global packing is held to the
single-process ``pack_slow_time`` element for element.
"""

import json

import jax
import numpy as np
import pytest
import torch

from fmcw_radar_processing_tpu.config import AlgorithmConfig as JAlgorithmConfig
from fmcw_radar_processing_tpu.config import RadarConfig as JRadarConfig
from fmcw_radar_processing_tpu.parallel.mesh import make_mesh as jmake_mesh
from fmcw_radar_processing_tpu.parallel.sp_recording import (
    ShardedRecordingPipeline as JShardedRecordingPipeline,
)
from fmcw_radar_processing_tpu_torch import config as tconfig
from fmcw_radar_processing_tpu_torch.io.synth import SyntheticTarget, synthesize_recording
from fmcw_radar_processing_tpu_torch.parallel.mesh import make_mesh
from fmcw_radar_processing_tpu_torch.parallel.sp_recording import ShardedRecordingPipeline
from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import (
    make_frame_chain,
    pack_slow_time,
)
from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline
from fmcw_radar_processing_tpu_torch.utils.cplx import pair_abs

from ._torch_parallel_ranks import spawn_worlds

WORLDS = (1, 2, 4)


def _cfg(**algo):
    return tconfig.RadarConfig.create(tconfig.default_device_config(),
                                      tconfig.AlgorithmConfig(stft_nfft=256, **algo))


def _inputs():
    cfg = _cfg()
    rng = np.random.default_rng(0)
    # The target absent from a quarter of the frames: the packing moves
    # samples across shard boundaries.
    present = np.ones(32, bool)
    present[rng.choice(32, 8, replace=False)] = False
    rec = synthesize_recording(
        cfg, 32, (SyntheticTarget(range_m=7.5, doppler_bin_offset=3,
                                  md_phase_rad=1.0, md_rate_hz=40.0),), seed=3,
        target_present=present)
    quiet = (0.001 * rng.standard_normal((8, cfg.pn, cfg.nts, 2))).astype(np.float32)
    return {"sp_raw": rec.rx1_pair(), "sp_calib": rec.calib_pair(0, cfg.nts),
            "spnone_raw": quiet, "spnone_calib": np.zeros((cfg.nts, 2), np.float32)}


INPUTS = _inputs()
_RUNS: dict = {}


def ranks(world: int) -> list[dict]:
    if not _RUNS:  # one spawn for worlds 1, 2 and 4
        _RUNS.update(spawn_worlds(WORLDS, INPUTS, ("sp",)))
    return _RUNS[world]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_sp():
    cfg = JRadarConfig.create(tconfig.default_device_config(),
                              JAlgorithmConfig(stft_nfft=256))
    cache = {}

    def get(world, name="sp_"):
        if (world, name) not in cache:
            mesh = jmake_mesh(data=world, model=1, devices=jax.devices()[:world])
            cache[world, name] = JShardedRecordingPipeline(cfg, mesh).process(
                INPUTS[name + "raw"], INPUTS[name + "calib"])
        return cache[world, name]

    return get


@pytest.fixture(scope="module")
def port_single():
    return RadarPipeline(_cfg(), device="cpu").process_recording(
        INPUTS["sp_raw"], INPUTS["sp_calib"])


def _assert_recording(got: dict, want: dict, cross: bool):
    """test_sp_recording.py:50-67's bounds. Across the two packages
    (``cross``) the STFT sums run in other orders, so the intensity takes
    the port's package-to-package bound instead (tests/test_torch_pipeline.py,
    from tests/test_stft_pallas.py): 2e-3 dB above −40 dB, 0.2 dB down to
    −120 dB, floors equal."""
    np.testing.assert_array_equal(got["sp_detected"], want["detected"])
    assert got["sp_detected"].any() and not got["sp_detected"].all()
    np.testing.assert_allclose(got["sp_waterfall"], want["waterfall"],
                               rtol=3e-4, atol=0.05)
    np.testing.assert_allclose(np.nan_to_num(got["sp_range"]),
                               np.nan_to_num(want["range"]), rtol=1e-5)
    np.testing.assert_allclose(np.nan_to_num(got["sp_speed"]),
                               np.nan_to_num(want["speed"]), rtol=1e-4, atol=1e-6)
    gi, wi = got["sp_spectrogram_intensity"], want["intensity"]
    assert gi.shape == wi.shape and gi.shape[1] > 0
    if cross:
        band, deep = wi > -40, wi > -120
        np.testing.assert_allclose(gi[band], wi[band], atol=2e-3)
        np.testing.assert_allclose(gi[deep], wi[deep], atol=0.2)
        np.testing.assert_array_equal(gi == -1000.0, wi == -1000.0)
    else:
        m = wi > -120
        np.testing.assert_allclose(gi[m], wi[m], atol=2e-3)
    payload = json.loads(got["sp_payload"].tobytes())
    assert len(payload["time"]) == gi.shape[1]
    assert len(payload["intensity"]) == 1024


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_recording_matches_jax(world, jax_sp):
    """vs JAX's ShardedRecordingPipeline on a ``world``-device mesh; every
    rank returns the same arrays."""
    want = jax_sp(world)
    res = ranks(world)
    _assert_recording(res[0], {
        "detected": want["detected"], "waterfall": want["waterfall"],
        "range": want["range"], "speed": want["speed"],
        "intensity": want["spectrogram_intensity"]}, cross=True)
    np.testing.assert_allclose(res[0]["sp_spectrogram_times"],
                               want["spectrogram_times"], rtol=1e-6)
    for other in res[1:]:
        for k, v in res[0].items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_recording_matches_the_port_pipeline(world, port_single):
    """vs the port's RadarPipeline.process_recording on the same recording
    (its export kernels' plain versions)."""
    want = port_single
    _assert_recording(ranks(world)[-1], {
        "detected": want.detected, "waterfall": want.waterfall,
        "range": want.target_range, "speed": want.target_speed,
        "intensity": want.spectrogram_intensity}, cross=False)


@pytest.mark.parametrize("world", WORLDS)
def test_global_packing_is_the_single_device_pack(world):
    """The ranks' chunks of the packed signal, gathered, are
    |pack_slow_time| of the single-process chain, element for element:
    the stable partition runs over the whole frame axis."""
    cfg = _cfg()
    raw = torch.as_tensor(INPUTS["sp_raw"]).reshape(32, cfg.pn, -1)
    out = make_frame_chain(cfg, "cpu")(raw, torch.as_tensor(INPUTS["sp_calib"]))
    sig, count = pack_slow_time(out.strongest_chirps, out.detected, cfg.pn)
    got = ranks(world)[0]
    assert int(got["sp_count"]) == int(count)
    assert 0 < int(count) < 32 * cfg.pn
    np.testing.assert_array_equal(got["sp_packed"], pair_abs(sig).numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_recording_no_detections(world, jax_sp):
    """count < window: no columns, a well-formed empty payload (as JAX)."""
    got = ranks(world)[0]
    want = jax_sp(world, "spnone_")
    assert not got["spnone_detected"].any() and not want["detected"].any()
    assert got["spnone_spectrogram_intensity"].shape == (1024, 0)
    assert got["spnone_spectrogram_db"].shape == want["spectrogram_db"].shape
    payload = json.loads(got["spnone_payload"].tobytes())
    assert len(payload["time"]) == 0 == len(want["payload"]["time"])


def test_requires_fixed_nfft_and_hop_1():
    """No stft_nfft raises ValueError on both sides; stft_hop 2 raises in
    the port (its sharded STFT is hop 1, as JAX's ShardedStft)."""
    mesh = make_mesh()
    with pytest.raises(ValueError, match="stft_nfft"):
        ShardedRecordingPipeline(
            tconfig.RadarConfig.create(tconfig.default_device_config()), mesh,
            device="cpu")
    with pytest.raises(ValueError, match="stft_nfft"):
        JShardedRecordingPipeline(
            JRadarConfig.create(tconfig.default_device_config()),
            jmake_mesh(data=2, model=1, devices=jax.devices()[:2]))
    with pytest.raises(ValueError, match="hop"):
        ShardedRecordingPipeline(_cfg(stft_hop=2), mesh, device="cpu")


def test_single_process_local_input():
    """Without a process group the pipeline runs on one rank; ``local``
    takes the whole recording as this rank's shard."""
    sp = ShardedRecordingPipeline(_cfg(), make_mesh(), device="cpu")
    a = sp.process(INPUTS["sp_raw"], INPUTS["sp_calib"])
    b = sp.process(INPUTS["sp_raw"], INPUTS["sp_calib"], local=True)
    for k in ("detected", "spectrogram_intensity", "waterfall"):
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a["spectrogram_intensity"],
                                  ranks(1)[0]["sp_spectrogram_intensity"])
