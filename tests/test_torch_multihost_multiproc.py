"""PyTorch port: the true two-process ``multihost.initialize`` — the
counterpart of tests/test_multihost_multiproc.py.

Two OS processes (tests/_torch_multihost_worker.py, ``subprocess.Popen``)
each call ``initialize("file://…", 2, pid, backend="gloo")`` on the CPU,
feed their own contiguous half of the 32-frame, two-target recording
(seed 5) through ``distribute_frames(local=True)`` and
``make_sharded_frame_chain``, gather the outputs and meet at
``on_host0``'s barrier. The rendezvous is a file in the test's temporary
directory, not a TCP port, so concurrent test workers cannot collide.
The gathered arrays must be identical in both processes, bit-identical to
the port's single-process chain, and within test_torch_parallel.py's
bounds of JAX's ``make_sharded_frame_chain`` on the same recording.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmcw_radar_processing_tpu.config import RadarConfig as JRadarConfig
from fmcw_radar_processing_tpu.config import (
    default_device_config as jdefault_device_config,
)
from fmcw_radar_processing_tpu.parallel.mesh import make_mesh as jmake_mesh
from fmcw_radar_processing_tpu.parallel.sharded_chain import (
    make_sharded_frame_chain as jmake_sharded_frame_chain,
)
from fmcw_radar_processing_tpu_torch.config import RadarConfig, default_device_config
from fmcw_radar_processing_tpu_torch.entry import example_recording
from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import make_frame_chain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_multihost_worker.py")
NPROC = 2
FRAMES = 32
TIMEOUT_S = 40  # a worker takes a few seconds; a hang fails here
KEYS = ("waterfall", "range", "speed", "detected")


@pytest.fixture(scope="module")
def gathered(tmp_path_factory):
    """Both workers' gathered outputs (one run for the module)."""
    out = tmp_path_factory.mktemp("multihost")
    coord = f"file://{out / 'rendezvous'}"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, coord, str(NPROC), str(pid), str(out), "gloo",
         "cpu"], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(NPROC)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{log}"
        assert f"worker {pid} ok" in log
    return out, [dict(np.load(out / f"proc{pid}.npz")) for pid in range(NPROC)]


def test_processes_gather_the_same_whole_recording(gathered):
    out, (g0, g1) = gathered
    assert set(g0) == {*KEYS, "k1a"}  # no card: no placement keys
    for k in KEYS:
        np.testing.assert_array_equal(g0[k], g1[k], err_msg=k)
    assert g0["waterfall"].shape == (FRAMES, 256)
    assert g0["range"].shape[1] == FRAMES and g0["detected"].any()
    assert int(g0["k1a"]) == int(g1["k1a"]) == 0  # the CPU runs no kernel
    assert (out / "host0_artifact").read_text() == "ok"


def test_processes_match_the_single_process_chain_bit_for_bit(gathered):
    """Frames are independent: the two processes' halves are the port's
    one-process chain on the whole recording, bit for bit."""
    _, (g0, _) = gathered
    cfg = RadarConfig.create(default_device_config())
    raw, calib = example_recording(cfg, FRAMES, seed=5)
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as in the workers
    try:
        want = make_frame_chain(cfg, "cpu")(torch.as_tensor(raw),
                                            torch.as_tensor(calib))
    finally:
        torch.set_num_threads(n)
    for k in KEYS:
        np.testing.assert_array_equal(g0[k], getattr(want, k).numpy(), err_msg=k)


def test_processes_match_jax_sharded_chain(gathered):
    """vs JAX's make_sharded_frame_chain on a 2-device mesh of the suite's
    virtual CPU devices, at test_torch_parallel.py's dp bounds: detections
    exact, waterfall rtol 1e-5, ranges rtol 1e-6, speeds rtol 1e-5 /
    atol 1e-6."""
    _, (g0, _) = gathered
    jcfg = JRadarConfig.create(jdefault_device_config())
    cfg = RadarConfig.create(default_device_config())
    raw, calib = example_recording(cfg, FRAMES, seed=5)
    pairs = raw.reshape(FRAMES, cfg.pn, cfg.nts, 2)  # JAX's [F, PN, NTS, 2]
    mesh = jmake_mesh(data=NPROC, model=1, devices=jax.devices()[:NPROC])
    want = jmake_sharded_frame_chain(jcfg, mesh)(jnp.asarray(pairs),
                                                 jnp.asarray(calib))
    np.testing.assert_array_equal(g0["detected"], np.asarray(want.detected))
    np.testing.assert_allclose(g0["waterfall"], np.asarray(want.waterfall), rtol=1e-5)
    np.testing.assert_allclose(g0["range"], np.asarray(want.range), rtol=1e-6)
    np.testing.assert_allclose(g0["speed"], np.asarray(want.speed), rtol=1e-5,
                               atol=1e-6)
