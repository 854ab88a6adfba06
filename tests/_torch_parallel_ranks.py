"""Rank bodies of the port's parallel tests (tests/test_torch_parallel.py,
test_torch_sp_recording.py, test_torch_parallel_train.py).

``spawn_worlds`` starts gloo ranks on the CPU through the port's
``entry.spawn_worlds`` (``torch.multiprocessing.spawn`` and a
``FileStore`` in a temporary directory, so concurrent test workers cannot
collide), one torch thread each; one spawn serves world sizes 1, 2 and 4.
In each world every rank runs the named parts of ``PARTS`` on the test's
inputs and gathers its outputs onto every rank; the tests then hold them
to the JAX package and to the port's single-process run. This module imports no JAX, so a rank
starts with the torch import alone.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import torch
import torch.distributed as dist


def _cfg(**algo):
    from fmcw_radar_processing_tpu_torch.config import (
        AlgorithmConfig,
        RadarConfig,
        default_device_config,
    )

    return RadarConfig.create(default_device_config(), AlgorithmConfig(**algo))


def _chain_arrays(prefix: str, out, mesh) -> dict:
    """A FrameChainOutputs' gathered arrays under ``prefix``."""
    from fmcw_radar_processing_tpu_torch.parallel.multihost import gather_to_all

    g = gather_to_all(out, mesh, {"strength": 1, "range": 1, "speed": 1})
    return {f"{prefix}waterfall": g.waterfall, f"{prefix}idx": g.detection.idx,
            f"{prefix}magnitude": g.detection.magnitude,
            f"{prefix}valid": g.detection.valid, f"{prefix}detected": g.detected,
            f"{prefix}range": g.range, f"{prefix}speed": g.speed,
            f"{prefix}strength": g.strength,
            f"{prefix}strongest": g.strongest_chirps}


def _raises(fn) -> int:
    """1 when fn raises ValueError, else 0."""
    try:
        fn()
    except ValueError:
        return 1
    return 0


def part_collectives(mesh_world, z, res):
    """The mesh's four collectives on rank-valued tensors, on the data
    mesh and, at world 4, on each axis of a 2×2 (data, model) mesh."""
    from fmcw_radar_processing_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        MODEL_AXIS,
        make_mesh,
    )

    mesh = make_mesh()
    r, n = mesh.rank, mesh.world
    t = torch.tensor([[r, 10 * r + 1]], dtype=torch.float32)
    res["ag_dim0"] = mesh.all_gather(t, DATA_AXIS, dim=0).numpy()
    res["ag_dim1"] = mesh.all_gather(t, DATA_AXIS, dim=1).numpy()
    res["psum"] = mesh.psum(t, DATA_AXIS).numpy()
    res["pmax"] = mesh.pmax(-t, (DATA_AXIS, MODEL_AXIS)).numpy()
    res["ring"] = mesh.ppermute(t, DATA_AXIS,
                                [(i, (i - 1) % n) for i in range(n)]).numpy()
    res["shift"] = mesh.ppermute(t, DATA_AXIS,
                                 [(i, i + 1) for i in range(n - 1)]).numpy()
    res["index"] = np.array([mesh.index(DATA_AXIS), mesh.index(MODEL_AXIS)])
    if n == 4:
        m2 = make_mesh(data=2, model=2)
        res["m2_index"] = np.array([m2.index(DATA_AXIS), m2.index(MODEL_AXIS)])
        res["m2_ag_model"] = m2.all_gather(t, MODEL_AXIS, dim=0).numpy()
        res["m2_ag_data"] = m2.all_gather(t, DATA_AXIS, dim=0).numpy()
        res["m2_psum_model"] = m2.psum(t, MODEL_AXIS).numpy()
        res["m2_psum_all"] = m2.psum(t, (DATA_AXIS, MODEL_AXIS)).numpy()
        res["m2_pmax_data"] = m2.pmax(t, DATA_AXIS).numpy()
        res["m2_ring_model"] = m2.ppermute(t, MODEL_AXIS, [(0, 1), (1, 0)]).numpy()


def part_chains(mesh_world, z, res):
    """The dp, tp and pp chains on the target recording, the tp chain on a
    noise-only one, the pp chain on one whose every other frame detects
    nothing, and the pp chain's raises."""
    from fmcw_radar_processing_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        Mesh,
        make_mesh,
    )
    from fmcw_radar_processing_tpu_torch.parallel.multihost import distribute_frames
    from fmcw_radar_processing_tpu_torch.parallel.pp_chain import (
        STAGE_AXIS,
        make_pp_frame_chain,
        make_pp_mesh,
    )
    from fmcw_radar_processing_tpu_torch.parallel.sharded_chain import (
        make_sharded_frame_chain,
    )
    from fmcw_radar_processing_tpu_torch.parallel.tp_chain import make_tp_frame_chain

    cfg = _cfg()
    n = mesh_world
    raw, calib, noise = z["raw"], z["calib"], z["noise"]
    mesh = make_mesh()
    out = make_sharded_frame_chain(cfg, mesh, "cpu")(
        distribute_frames(raw, mesh, "cpu"), calib)
    res.update(_chain_arrays("dp_", out, mesh))
    for mp in (1, 2, 4):
        if n % mp:
            continue
        tp_mesh = make_mesh(data=n // mp, model=mp)
        chain = make_tp_frame_chain(cfg, tp_mesh, "cpu")
        res.update(_chain_arrays(f"tp{mp}_", chain(
            distribute_frames(raw, tp_mesh, "cpu"), calib), tp_mesh))
        res.update(_chain_arrays(f"tpnoise{mp}_", chain(
            distribute_frames(noise, tp_mesh, "cpu"), calib), tp_mesh))
    if n % 2 == 0:
        pp_mesh = make_pp_mesh(n)
        for m in (2, 4):
            chain = make_pp_frame_chain(cfg, pp_mesh, m, "cpu")
            res.update(_chain_arrays(f"pp{m}_", chain(
                distribute_frames(raw, pp_mesh, "cpu"), calib), pp_mesh))
        chain = make_pp_frame_chain(cfg, pp_mesh, 2, "cpu")
        res.update(_chain_arrays("ppquiet_", chain(
            distribute_frames(z["quiet"], pp_mesh, "cpu"), calib), pp_mesh))
        res["pp_raises_microbatches"] = np.array(_raises(
            lambda: make_pp_frame_chain(cfg, pp_mesh, 3, "cpu")(
                distribute_frames(raw, pp_mesh, "cpu"), calib)))
    if n == 4:
        res["pp_raises_stage4"] = np.array(_raises(
            lambda: make_pp_frame_chain(cfg, Mesh(((DATA_AXIS, 1), (STAGE_AXIS, 4))),
                                        2, "cpu")))


def part_stft(mesh_world, z, res):
    """ShardedStft on a signal with a valid prefix, on an impulse right of
    the first shard boundary, and with each measurement switch off."""
    from fmcw_radar_processing_tpu_torch.dsp.stft import StftOperator
    from fmcw_radar_processing_tpu_torch.parallel.mesh import make_mesh
    from fmcw_radar_processing_tpu_torch.parallel.multihost import (
        distribute_frames,
        gather_to_all,
    )
    from fmcw_radar_processing_tpu_torch.parallel.sharded_stft import ShardedStft

    mesh = make_mesh()
    op = StftOperator.create(window_length=20, beta=3.0, nfft=256, fs=1000.0, hop=1)
    x = distribute_frames(z["stft_x"], mesh, "cpu")
    valid = int(z["stft_valid"])
    for name, kw in (("stft_", {}), ("stft_nohalo_", {"exchange_halo": False}),
                     ("stft_localmax_", {"global_db_max": False}),
                     ("stft_nodb_", {"compute_db": False})):
        p, db, v = ShardedStft(op=op, mesh=mesh, **kw)(x, valid)
        g = gather_to_all({"p": p, "db": db, "valid": v}, mesh,
                          {"p": 1, "db": 1, "valid": 0})
        res.update({name + k: a for k, a in g.items()})
    op64 = StftOperator.create(window_length=20, beta=3.0, nfft=64, fs=100.0, hop=1)
    imp = z["impulse"]
    for name, kw in (("impulse_", {}), ("impulse_nohalo_", {"exchange_halo": False})):
        p, _, _ = ShardedStft(op=op64, mesh=mesh, **kw)(
            distribute_frames(imp, mesh, "cpu"), imp.shape[0])
        res[name + "p"] = gather_to_all(p, mesh, 1)


def part_multihost(mesh_world, z, res):
    """The feed, the gather (the same on every rank), the host-0 call,
    the global mesh and a local shard taken as given."""
    from fmcw_radar_processing_tpu_torch.parallel.mesh import DATA_AXIS
    from fmcw_radar_processing_tpu_torch.parallel.multihost import (
        distribute_frames,
        gather_to_all,
        global_mesh,
        initialize,
        on_host0,
    )
    from fmcw_radar_processing_tpu_torch.parallel.sharded_chain import (
        make_sharded_frame_chain,
    )

    cfg = _cfg()
    rank = initialize()  # already initialized: returns the rank
    mesh = global_mesh()
    raw, calib = z["raw"], z["calib"]
    n, i = mesh.shape[DATA_AXIS], mesh.index(DATA_AXIS)
    f = raw.shape[0] // n
    given = distribute_frames(raw[i * f:(i + 1) * f], mesh, "cpu", local=True)
    cut = distribute_frames(raw, mesh, "cpu")
    res["mh_local_equal"] = np.array(int(torch.equal(given, cut)))
    out = make_sharded_frame_chain(cfg, mesh, "cpu")(given, calib)
    g = gather_to_all({"waterfall": out.waterfall, "detected": out.detected,
                       "range": out.range}, mesh, {"range": 1})
    res.update({"mh_" + k: v for k, v in g.items()})
    res["mh_rank"] = np.array(rank)
    res["mh_host0"] = np.array(int(on_host0(lambda: "ok") == "ok"))


def part_sp(mesh_world, z, res):
    """ShardedRecordingPipeline on the target recording and on a
    detection-free one."""
    from fmcw_radar_processing_tpu_torch.parallel.mesh import make_mesh
    from fmcw_radar_processing_tpu_torch.parallel.multihost import (
        distribute_frames,
        gather_to_all,
    )
    from fmcw_radar_processing_tpu_torch.parallel.sp_recording import (
        ShardedRecordingPipeline,
    )

    mesh = make_mesh()
    sp = ShardedRecordingPipeline(_cfg(stft_nfft=256), mesh, device="cpu")
    for name in ("sp_", "spnone_"):
        got = sp.process(z[name + "raw"], z[name + "calib"])
        for k, v in got.items():
            res[name + k] = (np.frombuffer(json.dumps(
                v, default=lambda a: np.asarray(a).tolist()).encode(), np.uint8)
                if k == "payload" else v)
    # The packed signal against the single-device pack, element for element.
    out = sp.chain(distribute_frames(z["sp_raw"], mesh, "cpu"), z["sp_calib"])
    sig, count = sp.pack(out.strongest_chirps, out.detected)
    res["sp_packed"] = gather_to_all(sig, mesh)
    res["sp_count"] = np.array(count)


def part_stream(mesh_world, z, res):
    """StreamingProcessor over the mesh: two windows in both dB modes,
    every channel given (each rank slices its own) and only the rank's
    channels given; the channel-count raise."""
    from fmcw_radar_processing_tpu_torch.parallel.mesh import make_mesh
    from fmcw_radar_processing_tpu_torch.parallel.multihost import gather_to_all
    from fmcw_radar_processing_tpu_torch.pipeline.streaming import StreamingProcessor

    cfg = _cfg()
    mesh = make_mesh()
    raw, calib = z["stream_raw"], z["stream_calib"]  # [C, 2·W, PN, NTS, 2]
    c, w = raw.shape[0], int(z["stream_window"])
    for mode in ("per_window", "running_max"):
        sp = StreamingProcessor(cfg, c, w, "cpu", db_mode=mode, mesh=mesh)
        c0, nc = sp.first_channel, sp.local_channels
        for i in range(2):
            win = raw[:, i * w:(i + 1) * w]
            if i == 0:
                r = sp.process_window(win, calib)
            else:  # only this rank's channels
                r = sp.process_window(win[c0:c0 + nc], calib[c0:c0 + nc])
            g = gather_to_all(r._asdict(), mesh)  # channels lead every field
            res.update({f"stream_{mode}_{i}_{k}": v for k, v in g.items()})
    res["stream_raises"] = np.array(_raises(
        lambda: StreamingProcessor(cfg, c + 1, w, "cpu", mesh=mesh)))


def part_train(mesh_world, z, res):
    """One data-parallel Trainer step from the given Flax parameters:
    float32 SmallCNN with dropout and augmentation off (the JAX
    comparison) and on (the one-process comparison); the batch raise."""
    from fmcw_radar_processing_tpu_torch.models.params import (
        flatten_tree,
        state_dict_to_flax,
        unflatten_tree,
    )
    from fmcw_radar_processing_tpu_torch.models.train import TrainConfig, Trainer
    from fmcw_radar_processing_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    params = unflatten_tree({k[2:]: v for k, v in z.items() if k.startswith("p/")})
    x, y = z["train_x"], z["train_y"]
    lr = float(z["train_lr"])
    for name, on in (("train_", False), ("train_drop_", True)):
        t = Trainer("small", TrainConfig(learning_rate=lr, epochs=1,
                                         batch_size=len(x), augment=on),
                    x.shape[1:], "cpu", mesh=mesh, dtype=torch.float32)
        t.set_params(params)
        if not on:
            t.model.dropout = 0.0
        t.fit(x, y)
        res[name + "loss"] = np.array(t.history[0]["loss"])
        res[name + "accuracy"] = np.array(t.history[0]["accuracy"])
        for k, v in flatten_tree(state_dict_to_flax(t.model.state_dict())).items():
            res[f"{name}p/{k}"] = np.asarray(v)
    if mesh.world > 1:
        t = Trainer("small", TrainConfig(epochs=1, batch_size=mesh.world + 1,
                                         augment=False),
                    x.shape[1:], "cpu", mesh=mesh, dtype=torch.float32)
        res["train_raises"] = np.array(_raises(lambda: t.fit(x, y)))


PARTS = {"collectives": part_collectives, "chains": part_chains,
         "stft": part_stft, "multihost": part_multihost, "sp": part_sp,
         "stream": part_stream, "train": part_train}


def run_parts(parts: tuple, device, inputs: dict) -> dict:
    """The named parts on this rank of the initialized group, on the
    test's inputs, on the CPU (the rank's ``device``); their results as
    one dict of arrays."""
    res: dict = {}
    for name in parts:
        PARTS[name](dist.get_world_size(), inputs, res)
    return res


def spawn_worlds(worlds: tuple, inputs: dict, parts: tuple) -> dict:
    """Run ``parts`` at each world size of ``worlds`` from one spawn of
    max(worlds) gloo ranks on the CPU, one torch thread each (the port's
    ``entry.spawn_worlds``); return {world: each rank's results as a dict
    of arrays, in rank order}."""
    from fmcw_radar_processing_tpu_torch.entry import spawn_worlds as spawn

    return spawn(worlds, functools.partial(run_parts, tuple(parts)), inputs,
                 "gloo", "cpu", threads=1)
