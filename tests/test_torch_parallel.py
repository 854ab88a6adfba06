"""PyTorch port: the parallel paths (parallel/) on torch.distributed.

The port's ranks run as spawned gloo processes on the CPU
(tests/_torch_parallel_ranks.py: a FileStore, one torch thread a rank) at
world sizes 1, 2 and 4; each gathers its outputs and the tests hold them
to the JAX package's sharded functions on the suite's 8 virtual CPU
devices (tests/conftest.py) and to the port's single-process chain.
Tolerances are those of the JAX package's own tests of each path:
test_parallel.py:33-37 and :57-84 (dp chain, sharded STFT, halo),
test_tp_chain.py and test_pp_chain.py, test_multihost.py; detections and
detection indices are exact everywhere.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmcw_radar_processing_tpu.config import RadarConfig as JRadarConfig
from fmcw_radar_processing_tpu.config import (
    default_device_config as jdefault_device_config,
)
from fmcw_radar_processing_tpu.dsp.stft import StftOperator as JStftOperator
from fmcw_radar_processing_tpu.dsp.stft import psd_db as jpsd_db
from fmcw_radar_processing_tpu.parallel.mesh import make_mesh as jmake_mesh
from fmcw_radar_processing_tpu.parallel.pp_chain import (
    make_pp_frame_chain as jmake_pp_frame_chain,
)
from fmcw_radar_processing_tpu.parallel.pp_chain import make_pp_mesh as jmake_pp_mesh
from fmcw_radar_processing_tpu.parallel.sharded_chain import (
    make_sharded_frame_chain as jmake_sharded_frame_chain,
)
from fmcw_radar_processing_tpu.parallel.sharded_stft import ShardedStft as JShardedStft
from fmcw_radar_processing_tpu.parallel.tp_chain import (
    make_tp_frame_chain as jmake_tp_frame_chain,
)
from fmcw_radar_processing_tpu.pipeline.frame_chain import (
    make_frame_chain as jmake_frame_chain,
)
from fmcw_radar_processing_tpu.utils.cplx import to_pair
from fmcw_radar_processing_tpu_torch import config as tconfig
from fmcw_radar_processing_tpu_torch.dsp.stft import StftOperator
from fmcw_radar_processing_tpu_torch.dsp.stft import psd_db as tpsd_db
from fmcw_radar_processing_tpu_torch.parallel import mesh as tmesh
from fmcw_radar_processing_tpu_torch.parallel import multihost as tmultihost
from fmcw_radar_processing_tpu_torch.parallel.pp_chain import (
    make_pp_frame_chain,
    make_pp_mesh,
)
from fmcw_radar_processing_tpu_torch.parallel.sharded_stft import ShardedStft
from fmcw_radar_processing_tpu_torch.parallel.tp_chain import make_tp_frame_chain
from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import make_frame_chain

from ._torch_parallel_ranks import spawn_worlds
from .conftest import make_recording

WORLDS = (1, 2, 4)
FIELDS = ("waterfall", "idx", "magnitude", "valid", "detected", "range",
          "speed", "strength", "strongest")


def _inputs():
    jcfg_dev = tconfig.default_device_config()
    cfg = tconfig.RadarConfig.create(jcfg_dev)
    rng = np.random.default_rng(42)
    frames, calib = make_recording(cfg, 16, rng)
    noise, _ = make_recording(cfg, 8, rng, target_bins=(), amplitude=0.0)
    # Every other frame weak noise alone: nothing there crosses the
    # detection threshold (tests/test_pipeline.py's _mixed_recording).
    quiet = noise.copy()
    quiet[::2] = (0.003 * (rng.standard_normal(quiet[::2].shape)
                           + 1j * rng.standard_normal(quiet[::2].shape))
                  ).astype(np.complex64)
    x = (1.0 + np.sin(2 * np.pi * 40.0 * np.arange(512) / 1000.0)
         + 0.1 * rng.standard_normal(512)).astype(np.float32)
    x[430:] = 0.0
    impulse = np.zeros(256, np.float32)
    impulse[[65, 129]] = 1.0  # right of the boundaries at 64 (world 4) and 128
    return {"raw": to_pair(np.swapaxes(frames, -1, -2)), "calib": to_pair(calib),
            "noise": to_pair(np.swapaxes(noise, -1, -2)),
            "quiet": to_pair(np.swapaxes(quiet, -1, -2)),
            "stft_x": x, "stft_valid": np.array(430), "impulse": impulse}


INPUTS = _inputs()
_RUNS: dict = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread in this process too, as in the ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ranks(world: int) -> list[dict]:
    """The ranks' results at ``world``: one spawn per test module."""
    if not _RUNS:  # one spawn for worlds 1, 2 and 4
        _RUNS.update(spawn_worlds(WORLDS, INPUTS, ("collectives", "chains", "stft",
                                                   "multihost")))
    return _RUNS[world]


def _jax_out(out) -> dict:
    return {"waterfall": out.waterfall, "idx": out.detection.idx,
            "magnitude": out.detection.magnitude, "valid": out.detection.valid,
            "detected": out.detected, "range": out.range, "speed": out.speed,
            "strength": out.strength, "strongest": out.strongest_chirps}


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's outputs, cached by (path, world, ...)."""
    cfg = JRadarConfig.create(jdefault_device_config())
    cache = {}
    raw, calib = jnp.asarray(INPUTS["raw"]), jnp.asarray(INPUTS["calib"])
    recs = {"targets": raw, "noise": jnp.asarray(INPUTS["noise"]),
            "quiet": jnp.asarray(INPUTS["quiet"])}

    def get(key):
        if key not in cache:
            kind, w, *rest = key
            devs = jax.devices()[:w]
            if kind == "dp":
                mesh = jmake_mesh(data=w, model=1, devices=devs)
                chain = jmake_sharded_frame_chain(cfg, mesh)
                cache[key] = _np(_jax_out(chain(raw, calib)))
            elif kind == "tp":
                mp, rec = rest
                mesh = jmake_mesh(data=w // mp, model=mp, devices=devs)
                cache[key] = _np(_jax_out(jmake_tp_frame_chain(cfg, mesh)(
                    recs[rec], calib)))
            elif kind == "pp":
                m, rec = rest
                chain = jmake_pp_frame_chain(cfg, jmake_pp_mesh(w), m)
                cache[key] = _np(_jax_out(chain(recs[rec], calib)))
            elif kind == "single":
                cache[key] = _np(_jax_out(jmake_frame_chain(cfg)(raw, calib)))
        return cache[key]

    return get


def _assert_chain(got: dict, prefix: str, want: dict, waterfall_rtol: float,
                  what: str):
    for k in ("detected", "valid", "idx"):
        np.testing.assert_array_equal(got[prefix + k], want[k], err_msg=f"{what} {k}")
    np.testing.assert_allclose(got[prefix + "waterfall"], want["waterfall"],
                               rtol=waterfall_rtol, err_msg=f"{what} waterfall")
    np.testing.assert_allclose(got[prefix + "range"], want["range"], rtol=1e-6,
                               err_msg=f"{what} range")
    np.testing.assert_allclose(got[prefix + "speed"], want["speed"], rtol=1e-5,
                               atol=1e-6, err_msg=f"{what} speed")


# --- the mesh and its collectives --------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_collectives(world):
    """all_gather (tiled, either dim), psum, pmax over every axis, the
    circular and the open ppermute (no sender: zeros), in axis order."""
    n = world
    vals = [np.array([[r, 10 * r + 1]], np.float32) for r in range(n)]
    for r, got in enumerate(ranks(world)):
        np.testing.assert_array_equal(got["ag_dim0"], np.concatenate(vals, 0))
        np.testing.assert_array_equal(got["ag_dim1"], np.concatenate(vals, 1))
        np.testing.assert_array_equal(got["psum"], sum(vals))
        np.testing.assert_array_equal(got["pmax"], -vals[0])
        np.testing.assert_array_equal(got["ring"], vals[(r + 1) % n])
        np.testing.assert_array_equal(got["shift"], vals[r - 1] if r else 0 * vals[0])
        np.testing.assert_array_equal(got["index"], [r, 0])


def test_collectives_on_each_axis_of_a_2x2_mesh():
    """Rank r of a (data 2, model 2) mesh sits at (r // 2, r % 2); each
    axis' collectives run over its own row or column."""
    res = ranks(4)
    vals = [np.array([[r, 10 * r + 1]], np.float32) for r in range(4)]
    for r, got in enumerate(res):
        d, m = divmod(r, 2)
        row, col = [2 * d, 2 * d + 1], [m, m + 2]
        np.testing.assert_array_equal(got["m2_index"], [d, m])
        np.testing.assert_array_equal(got["m2_ag_model"],
                                      np.concatenate([vals[i] for i in row]))
        np.testing.assert_array_equal(got["m2_ag_data"],
                                      np.concatenate([vals[i] for i in col]))
        np.testing.assert_array_equal(got["m2_psum_model"], sum(vals[i] for i in row))
        np.testing.assert_array_equal(got["m2_psum_all"], sum(vals))
        np.testing.assert_array_equal(got["m2_pmax_data"], vals[col[1]])
        np.testing.assert_array_equal(got["m2_ring_model"], vals[row[1 - m]])


def test_single_process_mesh_is_the_identity():
    """With no process group: a 1-rank mesh whose collectives return their
    operand, ppermute included, and building it starts no process group
    (the JAX package's single-process degenerate form)."""
    assert not torch.distributed.is_initialized()
    mesh = tmesh.make_mesh()
    assert (mesh.shape, mesh.rank, mesh.world, mesh.backend) == (
        {"data": 1, "model": 1}, 0, 1, None)
    t = torch.arange(6.0).reshape(2, 3)
    for got in (mesh.all_gather(t, "data", 1), mesh.psum(t, "data"),
                mesh.pmax(t, ("data", "model")),
                mesh.ppermute(t, "data", [(0, 0)])):
        assert torch.equal(got, t)
    assert torch.equal(mesh.ppermute(t, "data", []), torch.zeros_like(t))
    assert tmultihost.initialize() == 0
    assert tmultihost.on_host0(lambda: "ok") == "ok"
    assert not torch.distributed.is_initialized()


# --- the data-parallel chain ---------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_dp_chain_matches_jax(world, jax_ref):
    """vs make_sharded_frame_chain on a ``world``-device mesh (test_parallel.py:
    33-37): waterfall rtol 1e-5, detections and ranges; every rank holds
    the same gathered outputs."""
    res = ranks(world)
    _assert_chain(res[0], "dp_", jax_ref(("dp", world)), 1e-5, "dp")
    for other in res[1:]:
        for k in FIELDS:
            np.testing.assert_array_equal(other["dp_" + k], res[0]["dp_" + k])


@pytest.mark.parametrize("world", WORLDS)
def test_dp_chain_is_the_single_process_chain(world):
    """Frames are independent: the shards' outputs are the port's
    single-process chain's, bit for bit."""
    out = make_frame_chain(tconfig.RadarConfig.create(tconfig.default_device_config()),
                           "cpu")(torch.as_tensor(INPUTS["raw"]).reshape(16, 16, -1),
                                  torch.as_tensor(INPUTS["calib"]))
    got = ranks(world)[-1]
    np.testing.assert_array_equal(got["dp_waterfall"], out.waterfall.numpy())
    np.testing.assert_array_equal(got["dp_range"], out.range.numpy())
    np.testing.assert_array_equal(got["dp_strongest"], out.strongest_chirps.numpy())


# --- the tensor-parallel chain -------------------------------------------------

TP = [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)]


@pytest.mark.parametrize("rec", ["targets", "noise"])
@pytest.mark.parametrize("world,mp", TP)
def test_tp_chain_matches_jax(world, mp, rec, jax_ref):
    """vs make_tp_frame_chain on a (world/mp, mp) mesh (test_tp_chain.py):
    waterfall rtol 5e-4, detection indices exact (noise peaks too), ranges,
    speeds, and the strongest chirp row where a frame detects."""
    prefix = f"tp{mp}_" if rec == "targets" else f"tpnoise{mp}_"
    got = ranks(world)[-1]
    want = jax_ref(("tp", world, mp, rec))
    _assert_chain(got, prefix, want, 5e-4, f"tp {world}/{mp}")
    det = want["detected"]
    np.testing.assert_allclose(got[prefix + "strongest"][det],
                               want["strongest"][det], rtol=1e-4, atol=1e-4)


def test_tp_chain_rejects_indivisible_bins(cfg):
    """K = 256 over a 3-rank model axis raises, as JAX's does."""
    fake = types.SimpleNamespace(shape={"data": 1, "model": 3},
                                 index=lambda axis: 0)
    with pytest.raises(ValueError, match="not divisible by model axis 3"):
        make_tp_frame_chain(cfg, fake, "cpu")


# --- the pipeline-parallel chain -----------------------------------------------


@pytest.mark.parametrize("world,m", [(2, 2), (2, 4), (4, 2), (4, 4)])
def test_pp_chain_matches_jax(world, m, jax_ref, cfg):
    """vs make_pp_frame_chain on a (world/2, 2) mesh with M microbatches and
    vs the port's single-process impl "xla" (test_pp_chain.py: waterfall,
    strength and strongest rows rtol 1e-5, detections exact)."""
    got = ranks(world)[-1]
    want = jax_ref(("pp", world, m, "targets"))
    _assert_chain(got, f"pp{m}_", want, 1e-5, f"pp {world}/{m}")
    np.testing.assert_allclose(got[f"pp{m}_strength"], want["strength"], rtol=1e-5)
    np.testing.assert_allclose(got[f"pp{m}_strongest"], want["strongest"],
                               rtol=1e-5, atol=1e-6)
    xla = make_frame_chain(cfg, "cpu", impl="xla")(
        torch.as_tensor(INPUTS["raw"]), torch.as_tensor(INPUTS["calib"]))
    np.testing.assert_array_equal(got[f"pp{m}_waterfall"], xla.waterfall.numpy())
    np.testing.assert_array_equal(got[f"pp{m}_strongest"],
                                  xla.strongest_chirps.numpy())


@pytest.mark.parametrize("world", [2, 4])
def test_pp_chain_nan_for_undetected(world, jax_ref):
    """NaN-filled measurement slots survive the psum over ``stage``, on a
    recording whose every other frame detects nothing."""
    got = ranks(world)[-1]
    want = jax_ref(("pp", world, 2, "quiet"))
    np.testing.assert_array_equal(got["ppquiet_detected"], want["detected"])
    mask = ~got["ppquiet_valid"].T
    assert mask[:, ::2].all() and not mask.all()
    for k in ("range", "speed", "strength"):
        assert np.isnan(got["ppquiet_" + k][mask]).all()
        assert np.isnan(want[k][mask]).all()
    np.testing.assert_allclose(got["ppquiet_range"], want["range"], rtol=1e-6)


def test_pp_chain_raises_like_jax(cfg):
    """make_pp_mesh(3), a mesh without a ``stage`` axis, a 4-rank stage axis
    and frames per shard not divisible by M raise ValueError (the last two
    inside the ranks)."""
    with pytest.raises(ValueError, match="multiple of 2"):
        make_pp_mesh(3)
    with pytest.raises(ValueError, match="multiple of 2"):
        jmake_pp_mesh(3)
    with pytest.raises(ValueError, match="stage"):
        make_pp_frame_chain(cfg, tmesh.make_mesh(), 2, "cpu")
    with pytest.raises(ValueError, match="stage"):
        jmake_pp_frame_chain(cfg, jmake_mesh(data=2, model=4), 2)
    assert int(ranks(2)[0]["pp_raises_microbatches"]) == 1
    assert int(ranks(4)[0]["pp_raises_microbatches"]) == 1
    assert int(ranks(4)[0]["pp_raises_stage4"]) == 1


def test_mesh_raises_like_jax():
    """A mesh that does not cover the ranks, and a model axis that does not
    divide them, raise as JAX's make_mesh and global_mesh do."""
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        tmesh.make_mesh(data=2)
    with pytest.raises(ValueError, match="not divisible by model=2"):
        tmultihost.global_mesh(model=2)
    with pytest.raises(ValueError, match="mesh 3x1 != 8 devices"):
        jmake_mesh(data=3)


# --- the context-parallel STFT -------------------------------------------------


def _op(nfft, fs):
    return (StftOperator.create(window_length=20, beta=3.0, nfft=nfft, fs=fs, hop=1),
            JStftOperator.create(window_length=20, beta=3.0, nfft=nfft, fs=fs, hop=1))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_stft_matches_jax(world):
    """vs JAX's ShardedStft and its unsharded operator (test_parallel.py:
    40-64): power rtol 2e-4 / atol 1e-8, dB rtol 1e-4 / atol 2e-3 over the
    valid columns, zeros past them, valid-column count W−1 short."""
    got = ranks(world)[-1]
    _, jop = _op(256, 1000.0)
    x, valid = INPUTS["stft_x"], int(INPUTS["stft_valid"])
    mesh = jmake_mesh(data=world, model=1, devices=jax.devices()[:world])
    p_j, db_j, v_j = (np.asarray(a) for a in JShardedStft(op=jop, mesh=mesh)(
        jnp.asarray(x), valid))
    ref = jop(jnp.asarray(x), valid_len=jnp.asarray(valid))
    n_cols = valid - 20 + 1
    assert int(got["stft_valid"].sum()) == n_cols
    np.testing.assert_array_equal(got["stft_valid"], v_j)
    unsharded = (np.asarray(ref.power), np.asarray(jpsd_db(ref)))
    for want_p, want_db in ((p_j, db_j), unsharded):
        np.testing.assert_allclose(got["stft_p"][:, :n_cols], want_p[:, :n_cols],
                                   rtol=2e-4, atol=1e-8)
        # The dB of another package's sums: within the JAX bound where the
        # map is above -120 dB (test_sp_recording.py:61-66's band; below
        # it the power is under float32's resolution of the product).
        band = want_db[:, :n_cols] > -120.0
        np.testing.assert_allclose(got["stft_db"][:, :n_cols][band],
                                   want_db[:, :n_cols][band], rtol=1e-4, atol=2e-3)
    # The port's sharded STFT against its own unsharded operator: the full
    # bound of test_parallel.py:57-64 on every valid column.
    op, _ = _op(256, 1000.0)
    tref = op(torch.as_tensor(x), valid)
    np.testing.assert_allclose(got["stft_p"][:, :n_cols],
                               tref.power[:, :n_cols].numpy(), rtol=2e-4, atol=1e-8)
    np.testing.assert_allclose(got["stft_db"][:, :n_cols],
                               tpsd_db(tref.power)[:, :n_cols].numpy(),
                               rtol=1e-4, atol=2e-3)
    assert float(got["stft_p"][:, n_cols:].max()) == 0.0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_stft_halo_crosses_boundary(world):
    """Impulses right of the shard boundaries appear in the columns that
    start on the left neighbour exactly as in the unsharded operator
    (test_parallel.py:67-84: rtol 2e-4, atol 1e-10)."""
    op, jop = _op(64, 100.0)
    x = INPUTS["impulse"]
    ref = np.asarray(jop(jnp.asarray(x), valid_len=jnp.asarray(x.shape[0])).power)
    n_cols = x.shape[0] - 19
    got = ranks(world)[-1]["impulse_p"]
    np.testing.assert_allclose(got[:, :n_cols], ref[:, :n_cols], rtol=2e-4, atol=1e-10)
    np.testing.assert_allclose(
        got[:, :n_cols], op(torch.as_tensor(x), x.shape[0]).power[:, :n_cols].numpy(),
        rtol=2e-4, atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_exchange_halo_off_is_wrong_at_boundaries(world):
    """With exchange_halo=False the columns starting in the last W−1
    samples of a chunk lose the neighbour's samples: wrong at every
    boundary that an impulse crosses, the same as the halo run elsewhere
    (and everywhere at world 1, where there is no boundary)."""
    got = ranks(world)[-1]
    good, bad = got["impulse_p"], got["impulse_nohalo_p"]
    chunk = 256 // world
    near = np.zeros(good.shape[1], bool)
    for b in range(chunk, 256, chunk):
        near[b - 19:b] = True
    near[256 - 19:] = False  # the signal's own last W−1 starts: masked
    np.testing.assert_array_equal(bad[:, ~near], good[:, ~near])
    if world == 1:
        assert not near.any()
    else:
        wrong = np.abs(bad[:, near] - good[:, near]).max(axis=0) > 1e-6 * good.max()
        # Columns 110..127 (world 2) or 46..63 and 110..127 (world 4) read an
        # impulse across the boundary.
        assert wrong.sum() >= 18 * (1 if world == 2 else 2)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_stft_measurement_switches(world):
    """global_db_max=False normalizes each shard by its own max (its max
    column is 0 dB); compute_db=False returns the power in the dB slot."""
    got = ranks(world)[-1]
    chunk = 512 // world
    for s in range(world):
        cols = slice(s * chunk, (s + 1) * chunk)
        if got["stft_p"][:, cols].max() > 0:
            assert got["stft_localmax_db"][:, cols].max() == pytest.approx(0.0, abs=1e-4)
    assert got["stft_db"].max() == pytest.approx(0.0, abs=1e-4)
    np.testing.assert_array_equal(got["stft_nodb_db"], got["stft_nodb_p"])
    if world == 1:
        np.testing.assert_array_equal(got["stft_localmax_db"], got["stft_db"])


def test_sharded_stft_rejects_a_chunk_shorter_than_the_halo():
    fake = types.SimpleNamespace(shape={"data": 2}, axis_names=("data",),
                                 index=lambda axis: 0)
    op, _ = _op(64, 100.0)
    with pytest.raises(ValueError, match="halo"):
        ShardedStft(op=op, mesh=fake)(torch.zeros(10), 20)


# --- multi-host orchestration ---------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_multihost_feed_gather_and_host0(world, jax_ref):
    """A local shard taken as given equals the cut of the global array; the
    gathered waterfall has every frame and equals JAX's single-device
    chain within test_parallel.py's bound; on_host0 runs on rank 0 only;
    initialize() returns the rank."""
    want = jax_ref(("single", 1))
    for r, got in enumerate(ranks(world)):
        assert int(got["mh_local_equal"]) == 1
        assert got["mh_waterfall"].shape == (16, 256)
        np.testing.assert_allclose(got["mh_waterfall"], want["waterfall"], rtol=1e-5)
        np.testing.assert_array_equal(got["mh_detected"], want["detected"])
        np.testing.assert_allclose(got["mh_range"], want["range"], rtol=1e-6)
        assert int(got["mh_rank"]) == r
        assert int(got["mh_host0"]) == (r == 0)
