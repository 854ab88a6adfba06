"""The ranks of ``ShardedRecordingPipeline``: rank 0 in the benchmark's
process, ranks 1..n−1 spawned, one card each (``cuda:<rank>``), under one
NCCL group at tcp://localhost:<a free port>.

Every rank makes the same recordings from the seed on its own card (the
same generator on the same kind of card gives the same numbers; the set-up
checks it with a checksum over the group). Rank 0 leads: before each call
it broadcasts a command (process recording j, begin or end a trace, stop),
and every rank then runs the same call, as the sharded path needs. The
first calls of set-up form every communicator and peer link before the
window. At stop, each rank's peak memory and traced busy time come back
to rank 0 by an all-gather.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import socket
import sys
import time

PROCESS, STOP, TRACE_BEGIN, TRACE_END = 1, 0, 2, 3
JOIN_SECONDS = 60


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _pool(cfg: dict, traffic: dict, seed: int, device) -> list:
    from radarbench.gen import synth

    gen = synth.generator(seed, device)
    out = []
    for _ in range(traffic["pool"]):
        raw, calib, _ = synth.recording(
            cfg["device"], cfg["algorithm"], cfg["frames"], traffic["targets"], gen=gen,
            device=device, muted_share=traffic["muted_share"],
            noise_sigma=traffic["noise_sigma"], dc_offset=tuple(traffic["dc_offset"]))
        out.append((raw.cpu().numpy(), calib.cpu().numpy()))
        del raw
    return out


def _device(rank: int, kind: str):
    import torch

    return torch.device("cuda", rank) if kind == "cuda" else torch.device("cpu")


def _connect(rank: int, n: int, url: str, cfg: dict, traffic: dict, kind: str):
    """Join the group (NCCL on ``cuda:<rank>``; gloo for a CPU rehearsal)
    and build this rank's pipeline."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from fmcw_radar_processing_tpu_torch.parallel.mesh import make_mesh
    from fmcw_radar_processing_tpu_torch.parallel.sp_recording import (
        ShardedRecordingPipeline,
    )
    from radarbench import program

    dev = _device(rank, kind)
    if kind == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=url, world_size=n, rank=rank,
                                device_id=dev)
    else:
        dist.init_process_group("gloo", init_method=url, world_size=n, rank=rank)
    pipe = ShardedRecordingPipeline(program.radar_config(cfg), make_mesh(),
                                    traffic["filename"], device=dev)
    if cfg.get("fault") == "no_halo":  # a test's planted fault: no exchange
        pipe.stft = dataclasses.replace(pipe.stft, exchange_halo=False)
    if "chain_impl" in cfg:  # the control's chain, as sharded_chain wraps it
        from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import make_frame_chain

        chain = make_frame_chain(program.radar_config(cfg), dev, impl=cfg["chain_impl"])
        pn = cfg["device"]["num_chirps_per_frame"]

        def sharded(raw, calib):
            raw = torch.as_tensor(raw, dtype=torch.float32, device=dev)
            return chain(raw.reshape(raw.shape[0], pn, -1),
                         torch.as_tensor(calib, dtype=torch.float32, device=dev))

        pipe.chain = sharded
    return dev, pipe


def _checksums(pool, dev):
    """Every rank's checksum of each pool recording, as a [ranks, pool] list."""
    import numpy as np
    import torch
    import torch.distributed as dist

    mine = torch.tensor([float(np.sum(r, dtype=np.float64)) + float(np.sum(c, dtype=np.float64))
                         for r, c in pool], dtype=torch.float64, device=dev)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return [p.tolist() for p in parts]


def _stats(dev, busy: float, window: float):
    """All ranks' (peak memory bytes, traced busy seconds, traced window
    seconds)."""
    import torch
    import torch.distributed as dist

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    mine = torch.tensor([float(peak), busy, window], dtype=torch.float64, device=dev)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return [p.tolist() for p in parts]


def _worker(rank: int, n: int, url: str, cfg: dict, traffic: dict, seed: int,
            trace_dir: str, root: str, kind: str) -> None:
    sys.path.insert(0, root)
    import torch
    import torch.distributed as dist

    from radarbench import program
    from radarbench import trace as tr

    program.host_threads(cfg)
    pool = _pool(cfg, traffic, seed, _device(rank, kind))
    dev, pipe = _connect(rank, n, url, cfg, traffic, kind)
    _checksums(pool, dev)
    cmd = torch.zeros(2, dtype=torch.int64, device=dev)
    busy = window = 0.0
    path = os.path.join(trace_dir, f"trace_rank{rank}.json")
    while True:
        dist.broadcast(cmd, src=0)
        c, j = cmd.tolist()
        if c == PROCESS:
            pipe.process(*pool[j])
        elif c == TRACE_BEGIN:
            program.synchronize(dev)
            prof = tr.profiled(path)
            prof.__enter__()
            t0 = time.perf_counter()
        elif c == TRACE_END:
            program.synchronize(dev)
            window = time.perf_counter() - t0
            prof.__exit__(None, None, None)
            busy = tr.busy_seconds(tr.load_events(path)[0])
        else:
            break
    _stats(dev, busy, window)
    dist.destroy_process_group()


class Ranks:
    """Rank 0's handle on the group (see the module docstring)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, ranks: int, trace_dir,
                 kind: str = "cuda"):
        self.cfg, self.traffic, self.seed, self.n = cfg, traffic, seed, ranks
        self.kind = kind
        self.trace_dir = str(trace_dir)
        self.procs: list = []
        self.pipe = None
        self.memory_peak = 0
        self.busy, self.windows = [], []
        self.stopped = False

    def spawn(self) -> None:
        """Start ranks 1..n−1; they make their inputs while rank 0 does."""
        os.makedirs(self.trace_dir, exist_ok=True)
        self.url = f"tcp://localhost:{_free_port()}"
        ctx = mp.get_context("spawn")
        root = os.getcwd()
        for r in range(1, self.n):
            p = ctx.Process(target=_worker, args=(r, self.n, self.url, self.cfg,
                                                  self.traffic, self.seed,
                                                  self.trace_dir, root, self.kind),
                            daemon=True)
            p.start()
            self.procs.append(p)

    def connect(self, pool: list) -> None:
        import torch

        self.pool = pool
        self.dev, self.pipe = _connect(0, self.n, self.url, self.cfg, self.traffic,
                                       self.kind)
        sums = _checksums(pool, self.dev)
        if any(s != sums[0] for s in sums):
            raise RuntimeError(f"the ranks made different recordings: {sums}")
        self.cmd = torch.zeros(2, dtype=torch.int64, device=self.dev)

    def _send(self, c: int, j: int = 0) -> None:
        import torch.distributed as dist

        self.cmd.fill_(0)
        self.cmd[0], self.cmd[1] = c, j
        dist.broadcast(self.cmd, src=0)

    def process(self, j: int, timer=None) -> dict:
        self._send(PROCESS, j)
        return self.pipe.process(*self.pool[j])

    def trace_begin(self) -> None:
        self._send(TRACE_BEGIN)

    def trace_end(self) -> None:
        self._send(TRACE_END)

    def stop(self, busy0: float = 0.0, window0: float = 0.0) -> None:
        """Stop the other ranks; gather every rank's peak memory and traced
        busy and window seconds."""
        if self.stopped:
            return
        import torch.distributed as dist

        self._send(STOP)
        stats = _stats(self.dev, busy0, window0)
        self.memory_peak = int(max(s[0] for s in stats))
        self.busy = [s[1] for s in stats]
        self.windows = [s[2] for s in stats]
        self.stopped = True
        dist.destroy_process_group()  # every rank leaves the group together

    def close(self) -> None:
        import torch.distributed as dist

        deadline = time.monotonic() + JOIN_SECONDS
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        if dist.is_initialized():
            dist.destroy_process_group()
        self.pipe = None
