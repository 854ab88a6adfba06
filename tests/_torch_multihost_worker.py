"""Worker process of the port's true multi-process run: the counterpart of
tests/_multihost_worker.py, launched by tests/test_torch_multihost_multiproc.py
(gloo, on the CPU; and, in its ``cuda`` test, NCCL, one card a process) as

    python tests/_torch_multihost_worker.py <coordinator> <nproc> <pid> <outdir> <backend> <device>

Each worker is an OS process of its own that starts the group through
``multihost.initialize`` (the branch no spawned rank reaches), takes its
own contiguous chunk of the same 32-frame, two-target recording (seed 5),
feeds it through ``distribute_frames(local=True)`` and
``make_sharded_frame_chain``, gathers the outputs onto every process and
writes them to ``<outdir>/proc<pid>.npz``, with its card's index and UUID
and K1a's launches on a card; then process 0 writes ``host0_artifact``
under ``on_host0``, and after its barrier every process must see it. It
imports no JAX.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

FRAMES = 32
SEED = 5


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def main(argv: list[str]) -> int:
    coord, nproc, pid, outdir, backend, device = (
        argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4], argv[5])
    torch.set_num_threads(1)

    from fmcw_radar_processing_tpu_torch.config import (
        RadarConfig,
        default_device_config,
    )
    from fmcw_radar_processing_tpu_torch.entry import K1A, example_recording
    from fmcw_radar_processing_tpu_torch.ops import _lib
    from fmcw_radar_processing_tpu_torch.parallel import multihost as mh
    from fmcw_radar_processing_tpu_torch.parallel.sharded_chain import (
        make_sharded_frame_chain,
    )

    idx = mh.initialize(coord, nproc, pid, backend=backend)
    check(idx == pid, f"initialize returned {idx}, expected {pid}")
    check(dist.get_world_size() == nproc and dist.get_backend() == backend,
          f"a {backend} group of {nproc}")
    mesh = mh.global_mesh()
    check(mesh.shape == {"data": nproc, "model": 1}, f"global mesh {mesh}")
    placement = {}
    if device == "cuda":  # initialize made this process's own card current
        card = torch.cuda.current_device()
        check(card == pid % torch.cuda.device_count(),
              f"process {pid} on cuda:{card}")
        placement = {"card": card,
                     "uuid": str(torch.cuda.get_device_properties(card).uuid)}

    cfg = RadarConfig.create(default_device_config())
    raw, calib = example_recording(cfg, FRAMES, seed=SEED)
    chunk = FRAMES // nproc
    local = mh.distribute_frames(raw[pid * chunk:(pid + 1) * chunk], mesh,
                                 device, local=True)
    check(local.shape[0] == chunk, f"local shard {tuple(local.shape)}")
    chain = make_sharded_frame_chain(cfg, mesh, device)
    _lib.reset_launches()
    out = chain(local, torch.as_tensor(calib, device=local.device))
    k1a = _lib.LAUNCHES[K1A]
    got = mh.gather_to_all({"waterfall": out.waterfall, "range": out.range,
                            "speed": out.speed, "detected": out.detected},
                           mesh, {"range": 1, "speed": 1})
    check(got["waterfall"].shape[0] == FRAMES, "gathered frames")
    np.savez(os.path.join(outdir, f"proc{pid}.npz"), **got, k1a=k1a,
             **placement)

    artifact = os.path.join(outdir, "host0_artifact")

    def write():
        with open(artifact, "w") as fh:
            fh.write("ok")

    mh.on_host0(write)
    check(os.path.exists(artifact), "host 0's artifact after the barrier")
    dist.destroy_process_group()
    print(f"worker {pid} ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
