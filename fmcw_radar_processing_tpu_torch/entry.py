"""Entry points of the port, the counterparts of the repo's
``__graft_entry__.py``.

entry(device)           — the full per-recording forward on one device:
                          the chain, slow-time packing, the STFT, dB and
                          the log-frequency rescale, on 64 frames.
dryrun_multichip(n, …)  — starts n ranks (:func:`spawn_worlds`) and runs
                          on each the parallel paths of parallel/ against
                          the port's single-device chain, with the JAX
                          dryrun's tolerances.
spawn_worlds(worlds, …) — runs a function on every rank of one or more
                          world sizes (``torch.multiprocessing.spawn``, a
                          ``FileStore`` in a temporary directory; one
                          spawn serves them all), as the dryrun and the
                          port's parallel tests do.
"""

from __future__ import annotations

import datetime
import functools
import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from fmcw_radar_processing_tpu_torch.utils.cplx import resolve_device

PATHS = ("train", "dp", "tp", "pp", "stft", "sp", "multihost", "stream")
"""The checks of :func:`run_multichip_checks`, in the order they run."""
K1A = "fast_time_profile_b3"  # the launch counter of kernel K1a


def _example_recording(cfg, num_frames: int):
    """The JAX dryrun's recording: two targets, seed 0, as flat pair rows
    [F, PN, 2·NTS] and a [NTS, 2] calibration pair."""
    from fmcw_radar_processing_tpu_torch.io.synth import (
        SyntheticTarget,
        synthesize_recording,
    )
    from fmcw_radar_processing_tpu_torch.utils.cplx import to_pair

    rec = synthesize_recording(
        cfg, num_frames,
        (SyntheticTarget(range_m=7.5, doppler_bin_offset=3),
         SyntheticTarget(range_m=16.9, doppler_bin_offset=-2, amplitude=2.5)),
        seed=0)
    raw = to_pair(rec.rx1()).reshape(num_frames, cfg.pn, 2 * cfg.nts)
    return raw, to_pair(rec.calib_vector(0, cfg.nts))


def entry(device: torch.device | str = "cuda"):
    """Return (fn, example_args): the full-recording forward on ``device``
    (the card unless the caller asks for "cpu") and a 64-frame recording
    on it. fn(raw, calib) runs the chain (K1a on the card), the packing,
    the STFT PSD, dB and the rescale, and returns real tensors only."""
    from fmcw_radar_processing_tpu_torch.config import (
        AlgorithmConfig,
        RadarConfig,
        default_device_config,
    )
    from fmcw_radar_processing_tpu_torch.dsp.stft import (
        StftOperator,
        log_frequency_rescale,
        psd_db,
    )
    from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import (
        make_frame_chain,
        pack_slow_time,
    )
    from fmcw_radar_processing_tpu_torch.utils.cplx import pair_abs

    device = resolve_device(device)
    cfg = RadarConfig.create(default_device_config(), AlgorithmConfig(stft_nfft=256))
    chain = make_frame_chain(cfg, device)
    op = StftOperator.create(
        window_length=cfg.algorithm.stft_window_length,
        beta=cfg.algorithm.stft_kaiser_beta, nfft=cfg.algorithm.stft_nfft,
        fs=1.0 / cfg.derived.prt, hop=1)
    freqs = (np.arange(op.num_bins, dtype=np.float32)
             * np.float32(op.fs / op.nfft))

    def forward(raw: torch.Tensor, calib: torch.Tensor) -> dict:
        out = chain(raw, calib)
        sig, count = pack_slow_time(out.strongest_chirps, out.detected, cfg.pn)
        res = op(pair_abs(sig), valid_len=count)
        _, intensity = log_frequency_rescale(freqs, psd_db(res.power),
                                             cfg.algorithm.max_freq_bins)
        return {"waterfall": out.waterfall, "range": out.range,
                "speed": out.speed, "strength": out.strength,
                "detected": out.detected, "spectrogram_intensity": intensity}

    raw, calib = _example_recording(cfg, 64)
    return forward, (torch.as_tensor(raw, device=device),
                     torch.as_tensor(calib, device=device))


def check_vs_single(sharded, single, what: str) -> None:
    """The JAX dryrun's ``_check_vs_single``, on gathered NumPy outputs:
    detection masks and bin indices exact; the waterfall at rtol 3e-4 /
    atol 0.05 (the sharded and single programs sum in other orders);
    ranges at rtol 1e-5, speeds at rtol 1e-4 / atol 1e-6 (NaN as 0)."""
    np.testing.assert_array_equal(
        np.asarray(sharded.detected), np.asarray(single.detected),
        err_msg=f"{what}: detected mask diverged from single-device")
    np.testing.assert_array_equal(
        np.asarray(sharded.detection.idx), np.asarray(single.detection.idx),
        err_msg=f"{what}: detection indices diverged from single-device")
    np.testing.assert_allclose(
        np.asarray(sharded.waterfall), np.asarray(single.waterfall),
        rtol=3e-4, atol=0.05,
        err_msg=f"{what}: waterfall diverged from single-device")
    np.testing.assert_allclose(
        np.nan_to_num(np.asarray(sharded.range)),
        np.nan_to_num(np.asarray(single.range)), rtol=1e-5,
        err_msg=f"{what}: range diverged from single-device")
    np.testing.assert_allclose(
        np.nan_to_num(np.asarray(sharded.speed)),
        np.nan_to_num(np.asarray(single.speed)), rtol=1e-4, atol=1e-6,
        err_msg=f"{what}: speed diverged from single-device")


def _host(out):
    """A FrameChainOutputs as NumPy arrays."""
    from fmcw_radar_processing_tpu_torch.parallel.multihost import _tree_map

    return _tree_map(lambda t, _: None if t is None else t.cpu().numpy(), out, 0)


def _max_masked_diff(got: np.ndarray, want: np.ndarray, floor: float) -> float:
    """max |got − want| where want > floor, by torch's threads (the
    65,536-frame maps are 4 GB each)."""
    g, w = torch.from_numpy(got), torch.from_numpy(want)
    if g.shape != w.shape:
        raise AssertionError(f"shapes {tuple(g.shape)} vs {tuple(w.shape)}")
    if w.numel() == 0:
        return 0.0
    return float(torch.where(w > floor, (g - w).abs(), 0.0).amax())


def run_multichip_checks(device: torch.device | str, raw: np.ndarray,
                         calib: np.ndarray, paths=PATHS,
                         stream_window: int = 2) -> dict:
    """Run the parallel paths on this rank of the initialized process group
    (one rank without one) and hold each to the single-device chain on the
    same device; raise AssertionError on a mismatch.

    raw: the whole recording [F, PN, 2·NTS] (F divisible by the world size
    and, for the pp chain's 4 microbatches a data shard, by 4·world/2),
    calib [NTS, 2].
    Returns {"rank", "world", "backend", "checks_s": this function's wall
    time, "references_s": the single-device chains', path: {"seconds": the
    path's wall time on this rank, "k1a": K1a launches in it, "check_s":
    the time of its reference and comparison}}.
    """
    from fmcw_radar_processing_tpu_torch.config import (
        AlgorithmConfig,
        RadarConfig,
        default_device_config,
    )
    from fmcw_radar_processing_tpu_torch.dsp.stft import StftOperator, psd_db
    from fmcw_radar_processing_tpu_torch.models.train import TrainConfig, Trainer
    from fmcw_radar_processing_tpu_torch.ops import _lib
    from fmcw_radar_processing_tpu_torch.parallel.mesh import make_mesh
    from fmcw_radar_processing_tpu_torch.parallel.multihost import (
        distribute_frames,
        gather_to_all,
        on_host0,
    )
    from fmcw_radar_processing_tpu_torch.parallel.pp_chain import (
        make_pp_frame_chain,
        make_pp_mesh,
    )
    from fmcw_radar_processing_tpu_torch.parallel.sharded_chain import (
        make_sharded_frame_chain,
    )
    from fmcw_radar_processing_tpu_torch.parallel.sharded_stft import ShardedStft
    from fmcw_radar_processing_tpu_torch.parallel.sp_recording import (
        ShardedRecordingPipeline,
    )
    from fmcw_radar_processing_tpu_torch.parallel.tp_chain import make_tp_frame_chain
    from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import make_frame_chain
    from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline
    from fmcw_radar_processing_tpu_torch.pipeline.streaming import StreamingProcessor

    device = resolve_device(device)
    mesh = make_mesh()
    n = mesh.world
    cfg = RadarConfig.create(default_device_config())
    f = raw.shape[0]
    dims = {"strength": 1, "range": 1, "speed": 1}
    report: dict = {"rank": mesh.rank, "world": n, "backend": mesh.backend}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(path, fn):
        """fn() from a barrier, device-synced, with K1a's launches counted."""
        mesh.barrier()
        sync()
        _lib.reset_launches()
        t0 = time.perf_counter()
        result = fn()
        sync()
        report[path] = {"seconds": time.perf_counter() - t0,
                        "k1a": _lib.LAUNCHES[K1A]}
        return result

    def checked(path, t0):
        """Record the time the path's block took besides the path itself:
        its reference and its comparison."""
        report[path]["check_s"] = (time.perf_counter() - t0
                                   - report[path]["seconds"])

    def expect_k1a(path, count):
        if device.type == "cuda" and report[path]["k1a"] != count:
            raise AssertionError(f"{path}: K1a launched {report[path]['k1a']} "
                                 f"times, expected {count}")

    t_start = time.perf_counter()
    raw_t = torch.as_tensor(raw, dtype=torch.float32, device=device)
    calib_t = torch.as_tensor(calib, dtype=torch.float32, device=device)
    # The single-device references: the default chain (K1a on the card)
    # for the paths that run it, the float32 operator chain (impl "xla")
    # for tp and pp, whose products are that operator's (as JAX's pp test
    # holds its chain to impl "xla"; K1a's bf16x3 profile is 2^-17 of
    # max|x|·|W| off it, beyond the waterfall bound at small bins).
    single = exact = None
    if {"dp", "multihost"} & set(paths):
        single = _host(make_frame_chain(cfg, device)(raw_t, calib_t))
    if {"tp", "pp"} & set(paths) and n % 2 == 0:
        exact = _host(make_frame_chain(cfg, device, impl="xla")(raw_t, calib_t))
    report["references_s"] = time.perf_counter() - t_start

    # 1. A classifier training step, data-parallel over the batch: SmallCNN
    # at float32 with dropout off, against the same step on one process.
    if "train" in paths:
        t_path = time.perf_counter()
        rng = np.random.default_rng(0)
        x = rng.uniform(0, 1, (2 * n, 16, 16, 3)).astype(np.float32)
        y = (np.arange(2 * n) % 2).astype(np.float32)
        tcfg = TrainConfig(epochs=1, batch_size=2 * n, augment=False)
        trainers = []
        for m in (mesh, None):
            t = Trainer("small", tcfg, (16, 16, 3), device, mesh=m,
                        dtype=torch.float32)
            t.model.dropout = 0.0
            trainers.append(t)
        timed("train", lambda: trainers[0].fit(x, y))
        trainers[1].fit(x, y)
        dp_t, one = trainers
        if not np.isfinite(dp_t.history[0]["loss"]):
            raise AssertionError("dp train step: loss not finite")
        np.testing.assert_allclose(dp_t.history[0]["loss"], one.history[0]["loss"],
                                   rtol=1e-5, err_msg="dp train step: loss")
        lr = tcfg.learning_rate
        for (name, p), q in zip(dp_t.model.named_parameters(),
                                one.model.parameters()):
            # One Adam step moves each parameter by about lr·sign(g): a
            # reassociated gradient sum moves it by far less than lr where
            # |g| is clear of rounding (> 1e-4·max|g|), by at most 2·lr
            # where it is not (the bound of tests/test_torch_train.py).
            d = (p - q).detach().abs()
            g = q.grad.abs()
            near = float(d[g > 1e-4 * g.max()].max()) if g.any() else 0.0
            if not (float(d.max()) <= 2 * lr and near <= 1e-2 * lr):
                raise AssertionError(f"dp train step: {name} moved {float(d.max())} "
                                     "from the one-process step")
        checked("train", t_path)

    # 2. The data-parallel chain, frames sharded over the mesh.
    if "dp" in paths:
        t_path = time.perf_counter()
        chain = make_sharded_frame_chain(cfg, mesh, device)
        local = distribute_frames(raw, mesh, device)
        out = timed("dp", lambda: chain(local, calib_t))
        expect_k1a("dp", 1)
        gathered = gather_to_all(out, mesh, dims)
        check_vs_single(gathered, single, "dp-sharded chain")
        if device.type == "cuda":  # K1a computes each frame alone
            np.testing.assert_array_equal(gathered.waterfall, single.waterfall,
                                          err_msg="dp chain: K1a's waterfall")
        checked("dp", t_path)

    # 3. The tensor-parallel chain: range bins over a 2-rank model axis.
    if "tp" in paths and n % 2 == 0:
        t_path = time.perf_counter()
        tp_mesh = make_mesh(data=n // 2, model=2)
        chain = make_tp_frame_chain(cfg, tp_mesh, device)
        local = distribute_frames(raw, tp_mesh, device)
        out = timed("tp", lambda: chain(local, calib_t))
        expect_k1a("tp", 0)
        check_vs_single(gather_to_all(out, tp_mesh, dims), exact, "tp chain")
        checked("tp", t_path)

    # 4. The pipeline-parallel chain over a 2-rank stage axis.
    if "pp" in paths and n % 2 == 0:
        t_path = time.perf_counter()
        pp_mesh = make_pp_mesh(n)
        chain = make_pp_frame_chain(cfg, pp_mesh, 4, device)  # M = 4
        local = distribute_frames(raw, pp_mesh, device)
        out = timed("pp", lambda: chain(local, calib_t))
        expect_k1a("pp", 0)
        check_vs_single(gather_to_all(out, pp_mesh, dims), exact, "pp chain")
        checked("pp", t_path)

    # 5. The context-parallel STFT with its halo exchange: the columns of
    # the unsharded operator.
    if "stft" in paths:
        t_path = time.perf_counter()
        length = f * cfg.pn
        sig = (1.0 + np.sin(2 * np.pi * 0.05 * np.arange(length))).astype(np.float32)
        op = StftOperator.create(window_length=20, beta=3.0, nfft=256,
                                 fs=1.0 / cfg.derived.prt, hop=1)
        sig_t = torch.as_tensor(sig, device=device)
        local = distribute_frames(sig, mesh, device)
        p, db, _ = timed("stft", lambda: ShardedStft(op=op, mesh=mesh)(local, length))
        p, db = (gather_to_all({"p": p, "db": db}, mesh, 1)[k] for k in ("p", "db"))
        ref = op(sig_t, valid_len=length).power
        n_cols = length - 20 + 1
        np.testing.assert_allclose(
            p[:, :n_cols], ref[:, :n_cols].cpu().numpy(), rtol=1e-5, atol=1e-6,
            err_msg="sp STFT: halo-exchange columns diverged from unsharded")
        np.testing.assert_allclose(
            db[:, :n_cols], psd_db(ref)[:, :n_cols].cpu().numpy(), rtol=1e-4,
            atol=2e-3, err_msg="sp STFT: dB diverged from unsharded")
        checked("stft", t_path)

    # 6. The integrated sp recording export against the single-device
    # pipeline: detections exact, intensity within 2e-3 dB above -120 dB.
    # The reference runs the same export branch (stft_impl "xla"), so that
    # its rescale takes the same passes as the sp one's: rescale_precision
    # "high" is three bf16 passes on the card, up to 3·2^-18 relative off
    # the exact float32 kernel export (2.1e-3 dB near -120 dB at 65,536
    # frames on an NVIDIA H100).
    if "sp" in paths:
        t_path = time.perf_counter()
        cfg256 = RadarConfig.create(cfg.device, AlgorithmConfig(stft_nfft=256))
        sp = ShardedRecordingPipeline(cfg256, mesh, device=device)
        got = timed("sp", lambda: sp.process(raw, calib))
        expect_k1a("sp", 1)
        ref_cfg = RadarConfig.create(cfg.device, AlgorithmConfig(stft_nfft=256,
                                                                 stft_impl="xla"))
        want = RadarPipeline(ref_cfg, device=device).process_recording(raw, calib)
        np.testing.assert_array_equal(got["detected"], want.detected,
                                      err_msg="sp recording: detected")
        err = _max_masked_diff(got["spectrogram_intensity"],
                               want.spectrogram_intensity, -120.0)
        report["sp"]["intensity_max_abs_err_db"] = err
        if not err <= 2e-3:
            raise AssertionError(f"sp recording: intensity {err} dB from the "
                                 "single-device pipeline (bound 2e-3 where > -120)")
        del got, want
        checked("sp", t_path)

    # 7. The multi-host feed, gather and host-0 call.
    if "multihost" in paths:
        t_path = time.perf_counter()
        chain = make_sharded_frame_chain(cfg, mesh, device)
        local = distribute_frames(raw, mesh, device)
        gathered = timed("multihost", lambda: gather_to_all(
            {"waterfall": chain(local, calib_t).waterfall}, mesh))
        if gathered["waterfall"].shape[0] != f:
            raise AssertionError("multihost: gathered waterfall frames")
        np.testing.assert_allclose(gathered["waterfall"], single.waterfall,
                                   rtol=3e-4, atol=0.05,
                                   err_msg="multihost: gathered waterfall")
        if on_host0(lambda: "ok") != ("ok" if mesh.rank == 0 else None):
            raise AssertionError("multihost: on_host0")
        checked("multihost", t_path)

    # 8. Streaming over the mesh: 2·n channels over the data axis, two
    # windows, running-max dB state carried between them.
    if "stream" in paths:
        t_path = time.perf_counter()
        c, w = 2 * n, stream_window
        frames = raw[: c * 2 * w].reshape(c, 2, w, *raw.shape[1:])
        cal_s = np.broadcast_to(calib, (c, *calib.shape)).copy()
        sharded = StreamingProcessor(cfg, c, w, device, mesh=mesh,
                                     db_mode="running_max")
        whole = StreamingProcessor(cfg, c, w, device, db_mode="running_max")
        res = timed("stream", lambda: [sharded.process_window(frames[:, i], cal_s)
                                       for i in range(2)])
        expect_k1a("stream", 2 * (c // n))
        c0 = sharded.first_channel
        for i in range(2):
            ref = whole.process_window(frames[:, i], cal_s)
            got = gather_to_all({"psd": res[i].psd, "col": res[i].col_count}, mesh)
            np.testing.assert_array_equal(got["col"], ref.col_count.cpu().numpy(),
                                          err_msg="stream: col_count")
            np.testing.assert_allclose(
                got["psd"], ref.psd.cpu().numpy(), rtol=1e-2, atol=1e-10,
                err_msg="stream: psd")
            np.testing.assert_array_equal(
                res[i].detected.cpu().numpy(),
                ref.detected[c0:c0 + c // n].cpu().numpy(),
                err_msg="stream: detected")
        checked("stream", t_path)
    report["checks_s"] = time.perf_counter() - t_start
    return report


def _rank_body(rank: int, worlds: tuple, backend: str, device: str, tmp: str,
               fn, threads: int | None, payload=None) -> None:
    """One rank of :func:`spawn_worlds`: for each world size it belongs to
    (rank < world), join that world's process group through its
    FileStore, run fn(payload), write the result, and leave the group."""
    if threads:
        torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    if payload is None:
        with open(os.path.join(tmp, "payload.pkl"), "rb") as fh:
            payload = pickle.load(fh)
    for world in worlds:
        if rank >= world:
            continue
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, f"store{world}"), world),
            rank=rank, world_size=world, timeout=datetime.timedelta(seconds=600))
        try:
            result = fn(payload)
            with open(os.path.join(tmp, f"world{world}_rank{rank}.pkl"), "wb") as fh:
                pickle.dump(result, fh)
        finally:
            dist.destroy_process_group()


def spawn_worlds(worlds, fn, payload, backend: str = "gloo",
                 device: torch.device | str = "cpu",
                 threads: int | None = None) -> dict:
    """Run fn(payload) on every rank of a ``backend`` process group at each
    world size of ``worlds``, and return {world: the results in rank
    order}.

    fn is a picklable callable (a module-level function, or a
    ``functools.partial`` of one) that reads its rank and world from the
    initialized group; its result and ``payload`` must pickle. Ranks are
    one ``torch.multiprocessing.spawn`` of max(worlds) processes with a
    ``FileStore`` in a temporary directory (no TCP port, so concurrent
    callers cannot collide); each rank joins the worlds it belongs to in
    turn, paying its start-up once. World 1 alone runs in the calling
    process, with a process group of its own for the call. ``threads``
    sets each rank's torch threads; ``device`` is the device each rank
    selects. A failing rank raises here.
    """
    worlds = tuple(worlds)
    with tempfile.TemporaryDirectory(prefix="fmcw_ranks_") as tmp:
        if worlds == (1,):
            if dist.is_initialized():
                raise RuntimeError("a process group is already initialized")
            threads_before = torch.get_num_threads()
            try:
                _rank_body(0, worlds, backend, str(device), tmp, fn, threads, payload)
            finally:
                torch.set_num_threads(threads_before)
        else:
            import torch.multiprocessing as mp

            with open(os.path.join(tmp, "payload.pkl"), "wb") as fh:
                pickle.dump(payload, fh, protocol=pickle.HIGHEST_PROTOCOL)
            mp.spawn(_rank_body, nprocs=max(worlds), join=True,
                     args=(worlds, backend, str(device), tmp, fn, threads))
        results = {}
        for w in worlds:
            results[w] = []
            for r in range(w):
                with open(os.path.join(tmp, f"world{w}_rank{r}.pkl"), "rb") as fh:
                    results[w].append(pickle.load(fh))
        return results


def _checks_on_rank(device: str, checks: dict, recording) -> dict:
    """:func:`run_multichip_checks` on this rank of the group."""
    return run_multichip_checks(device, *recording, **checks)


def dryrun_multichip(n_devices, backend: str = "gloo",
                     device: torch.device | str = "cuda",
                     frames: int | None = None, recording=None,
                     threads: int | None = None, **checks):
    """Run the multi-chip paths on ``n_devices`` ranks of a ``backend``
    process group ("gloo", or "nccl" on CUDA), every rank computing on
    ``device`` (the card unless the caller asks for "cpu"), and check each
    against the single-device chain (:func:`run_multichip_checks`).

    recording: (raw [F, PN, 2·NTS], calib [NTS, 2]), or the JAX dryrun's
    two-target recording of ``frames`` frames (default 8 a rank).
    ``threads`` sets each rank's torch threads; ``checks`` go to
    :func:`run_multichip_checks` (``paths``, ``stream_window``). The ranks
    are :func:`spawn_worlds`' (one rank runs in the calling process),
    after the CUDA kernels are built here once. A failing rank raises
    here. Returns the ranks' reports in rank order; for a sequence of
    world sizes, a dict of them by size, from one spawn of the largest.
    """
    device = resolve_device(device)
    worlds = (n_devices,) if isinstance(n_devices, int) else tuple(n_devices)
    if recording is None:
        from fmcw_radar_processing_tpu_torch.config import (
            RadarConfig,
            default_device_config,
        )

        cfg = RadarConfig.create(default_device_config())
        recording = _example_recording(cfg, frames or 8 * max(worlds))
    raw, calib = (np.asarray(a, np.float32) for a in recording)
    if device.type == "cuda":
        from fmcw_radar_processing_tpu_torch.ops import _lib

        _lib.load_kernels()  # build once, not in every rank
    reports = spawn_worlds(worlds, functools.partial(_checks_on_rank, str(device), checks),
                           (raw, calib), backend, device, threads)
    return reports[worlds[0]] if isinstance(n_devices, int) else reports
