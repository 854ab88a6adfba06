"""Multi-process orchestration: process-group init, the frame feed, the
gather of outputs and host-0 work.

The JAX package runs one program across hosts (its
``parallel/multihost.py``): every process holds a shard of the frame axis,
XLA inserts the collectives, and process 0 writes the payloads. Here each
rank is its own process: :func:`distribute_frames` gives it its frames,
the chain runs on them with no communication, :func:`gather_to_all`
assembles the sharded outputs on every rank, and :func:`on_host0` runs the
writes on rank 0.

Single-process use degrades to no-ops, as in JAX: :func:`initialize`
starts no process group, the global mesh is the 1-rank mesh, and the
gather is a device-to-host copy.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from fmcw_radar_processing_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    process_group_ready,
    rank_device,
)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str = "nccl") -> int:
    """Start the default process group when ``num_processes`` > 1, and
    return this process's rank (0 when single-process).

    coordinator_address: "host:port" (TCP) or any ``init_method`` URL,
    such as "tcp://localhost:29500" or "file:///tmp/store"; backend:
    "nccl" (CUDA tensors) or "gloo" (CPU tensors; CUDA operands staged
    through the host by the mesh's collectives).

    Under NCCL the process first takes its own card (:func:`mesh.rank_device`)
    and makes it current, so that "cuda" means that card from then on (the
    chains' default, :func:`distribute_frames`), and binds the group to it
    (``device_id``): the card is ``LOCAL_RANK`` of ``LOCAL_WORLD_SIZE`` where
    the launcher sets them (torchrun), else ``process_id`` modulo the cards
    this host shows, processes filling hosts in order. Too few cards raise
    RuntimeError before the group starts.
    """
    if num_processes is not None and num_processes > 1:
        if coordinator_address is None or process_id is None:
            raise ValueError("a multi-process run needs coordinator_address "
                             "and process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        bind = {}
        if backend == "nccl":
            card = _process_card(num_processes, process_id)
            torch.cuda.set_device(card)
            bind["device_id"] = card
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id, **bind)
    return dist.get_rank() if process_group_ready() else 0


def _process_card(num_processes: int, process_id: int) -> torch.device:
    """This NCCL process's card (:func:`initialize`)."""
    if "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", local + 1))
    else:
        have = max(torch.cuda.device_count(), 1)
        local, local_world = process_id % have, min(num_processes, have)
    return rank_device("cuda", local, "nccl", local_world)


def global_mesh(model: int = 1) -> Mesh:
    """(data, model) mesh over every rank of every process."""
    n = dist.get_world_size() if process_group_ready() else 1
    if n % model:
        raise ValueError(f"{n} devices not divisible by model={model}")
    return Mesh(((DATA_AXIS, n // model), (MODEL_AXIS, model)))


def distribute_frames(raw, mesh: Mesh, device: torch.device | str = "cuda",
                      local: bool = False) -> torch.Tensor:
    """This rank's contiguous frame shard as a float32 tensor on
    ``device``.

    raw: the whole recording [F, ...] (F divisible by the data-axis size;
    shard i of the ``data`` axis is frames [i·F/n, (i+1)·F/n), replicated
    over the other axes), or with ``local`` this rank's shard, taken as
    given — the JAX package's host-local input.
    """
    if not local:
        n, i = mesh.shape[DATA_AXIS], mesh.index(DATA_AXIS)
        f = raw.shape[0]
        if f % n:
            raise ValueError(f"{f} frames not divisible by the data axis ({n})")
        raw = raw[i * (f // n):(i + 1) * (f // n)]
    return torch.as_tensor(raw, dtype=torch.float32).to(device)


def _tree_map(fn, tree, dims):
    def dim(key):
        return dims.get(key, 0) if isinstance(dims, dict) else dims

    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, dim(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(_tree_map(fn, v, dim(k))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, dims) for v in tree)
    return fn(tree, dims)


def gather_to_all(tree, mesh: Mesh, dims: dict | int = 0):
    """NumPy copies of sharded outputs, assembled along the ``data`` axis
    on every rank: each tensor leaf of ``tree`` (dicts, lists, tuples,
    NamedTuples; None stays None) is this rank's shard, concatenated with
    the other data-axis members' on its dimension ``dims`` (an int for
    every leaf, or a dict of them by key, 0 by default). Every rank
    returns the same values."""

    def gather(t, dim):
        if t is None:
            return None
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(np.asarray(t))
        is_bool = t.dtype == torch.bool
        out = mesh.all_gather(t.to(torch.uint8) if is_bool else t, DATA_AXIS,
                              dim=dim, to_host=True)
        out = out.cpu().numpy()
        return out.astype(bool) if is_bool else out

    return _tree_map(gather, tree, dims)


def on_host0(fn, *args, **kwargs):
    """Run fn only on rank 0 (payload writes, uploads); None elsewhere.
    A barrier follows, so no rank races ahead of the writes."""
    result = None
    rank = dist.get_rank() if process_group_ready() else 0
    if rank == 0:
        result = fn(*args, **kwargs)
    if process_group_ready() and dist.get_world_size() > 1:
        dist.barrier()
    return result
