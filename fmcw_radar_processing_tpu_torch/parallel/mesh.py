"""Process meshes over ``torch.distributed`` and the collectives the
parallel paths use.

The JAX package's mesh (its ``parallel/mesh.py``) is a grid of devices
driven by ONE controller: arrays are global, ``shard_map`` hands each
device its block, and XLA inserts the collectives. PyTorch's model is
multi-controller instead: one process per rank, each holding only its own
shard and calling the collectives itself. A :class:`Mesh` here is the
grid of the ranks of the initialized process group, row-major over its
axes (rank = Σ index·stride, as ``np.arange(world).reshape(shape)``),
with this rank's index along each axis and the sub-group of each axis.
Axes:

  * ``data``  — frames, channels, batch rows, and the slow-time/STFT
    time axis (context parallelism by halo exchange);
  * ``model`` — the range bins of the tensor-parallel chain.

Its four collectives are the ones the JAX modules call inside
``shard_map``: :meth:`Mesh.all_gather` (tiled, on an axis),
:meth:`Mesh.psum`, :meth:`Mesh.pmax` and :meth:`Mesh.ppermute`.

The backend is the process group's, chosen where it is initialized
(parallel/multihost.py::initialize). Under NCCL the collectives take the
CUDA tensors as they are. Under gloo, whose send, receive and all-gather
take CPU tensors only, every collective stages a CUDA operand through a
host copy and returns its result on the operand's device — in
:meth:`Mesh._staged`, for all four alike. That staging is what the gloo
backend costs; it is the caller's choice of backend, not a fallback.
Which card each process computes on is :func:`rank_device`'s rule: under
NCCL one card a process, as JAX's mesh holds n distinct devices.

With no process group initialized, :func:`make_mesh` gives the 1-rank
mesh whose collectives are identities — the JAX package's
single-process degenerate form (its ``parallel/multihost.py:12-14``).
Building a mesh never starts a process group.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.distributed as dist

from fmcw_radar_processing_tpu_torch.utils.cplx import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def process_group_ready() -> bool:
    """True when a default process group is initialized."""
    return dist.is_available() and dist.is_initialized()


def rank_device(device: torch.device | str, local_rank: int, backend: str,
                local_world: int) -> torch.device:
    """The device of the process at ``local_rank`` of the ``local_world``
    processes of a ``backend`` group on one host — the one placement rule
    of the spawned ranks (entry.py) and of :func:`multihost.initialize`.

    A CPU device stays as it is. Under NCCL each process has a card of its
    own, ``cuda:<local_rank>``, as the JAX package's mesh takes n distinct
    devices: RuntimeError when the host has fewer cards than processes,
    ValueError for an explicit index (one card cannot hold several NCCL
    ranks) unless there is one process. Under gloo, which stages every
    operand through the host, an explicit index serves every process and
    "cuda" gives ``cuda:<local_rank mod cards>``: all on ``cuda:0`` on a
    one-card host.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    have = torch.cuda.device_count()
    if backend == "nccl":
        if dev.index is not None and local_world > 1:
            raise ValueError(f"{dev} cannot hold {local_world} NCCL ranks: pass "
                             "'cuda' for one card a rank")
        need = max(local_world, local_rank + 1, (dev.index or 0) + 1)
        if have < need:
            raise RuntimeError(f"need {need} devices, have {have}")
        return dev if dev.index is not None else torch.device("cuda", local_rank)
    if dev.index is not None:
        return dev
    return torch.device("cuda", local_rank % have)


class Mesh:
    """This rank's view of a row-major grid of ranks with named axes.

    ``shape[axis]`` is the axis size and ``index(axis)`` this rank's
    coordinate on it; each axis has this rank's sub-group along it (its
    global ranks in axis order, and its process group). An axis with one
    rank needs no communication: its collectives are identities, except
    when it spans the whole world (world 1), where they run on the default
    group so that a 1-rank NCCL mesh still makes real calls.
    """

    def __init__(self, axes: Sequence[tuple[str, int]]):
        names = tuple(name for name, _ in axes)
        if len(set(names)) != len(names):
            raise ValueError(f"repeated mesh axis in {names}")
        self.axis_names = names
        self.shape = {name: int(size) for name, size in axes}
        if process_group_ready():
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
            self.backend = str(dist.get_backend())
        else:
            self.rank, self.world, self.backend = 0, 1, None
        if math.prod(self.shape.values()) != self.world:
            raise ValueError(
                f"mesh {' x '.join(map(str, self.shape.values()))} != "
                f"{self.world} ranks")
        strides, s = {}, 1
        for name in reversed(names):
            strides[name] = s
            s *= self.shape[name]
        self._coords = {n: (self.rank // strides[n]) % self.shape[n] for n in names}
        self._ranks: dict[str, list[int]] = {}
        self._groups: dict[str, object] = {}
        for name in names:
            self._ranks[name], self._groups[name] = self._axis_group(name, strides)

    def _axis_group(self, axis: str, strides: dict[str, int]):
        """(ranks of this rank's group along ``axis``, its process group or
        None). Every rank creates every group of the axis, in the same
        order, as ``dist.new_group`` requires."""
        n, stride = self.shape[axis], strides[axis]
        mine = [self.rank + (i - self._coords[axis]) * stride for i in range(n)]
        if self.backend is None or (n == 1 and self.world > 1):
            return mine, None
        if n == self.world:
            return mine, dist.group.WORLD
        group = None
        for base in range(self.world):
            if (base // stride) % n:  # not the axis' first member
                continue
            ranks = [base + i * stride for i in range(n)]
            g = dist.new_group(ranks)
            if ranks == mine:
                group = g
        return mine, group

    def __repr__(self) -> str:
        dims = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({dims}; rank {self.rank}, backend {self.backend})"

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
        return self._coords[axis]

    def _axes(self, axis: str | Sequence[str]) -> tuple[str, ...]:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"no axis {a!r} in {self.axis_names}")
        return axes

    def _staged(self, t: torch.Tensor, to_host: bool = False):
        """(operand for the backend, function putting a result back on
        ``t``'s device): a host copy under gloo for a CUDA tensor, else
        ``t`` itself. ``to_host`` leaves a staged result on the host."""
        if self.backend == "gloo" and t.is_cuda:
            return t.cpu(), (lambda r: r) if to_host else (lambda r: r.to(t.device))
        return t.contiguous(), lambda r: r

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0,
                   to_host: bool = False) -> torch.Tensor:
        """The members' ``t`` along ``axis`` concatenated on ``dim`` in
        axis order (``lax.all_gather(..., tiled=True)``); every member's
        ``t`` has the same shape. ``to_host``: the caller wants the result
        on the host, so a gloo-staged result is not copied back to the
        card."""
        group = self._groups[self._axes(axis)[0]]
        if group is None:
            return t
        x, back = self._staged(t, to_host)
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x, group=group)
        return back(torch.cat(parts, dim=dim))

    def _reduce(self, t: torch.Tensor, axis, op) -> torch.Tensor:
        axes = self._axes(axis)
        groups = [self._groups[a] for a in axes if self._groups[a] is not None]
        if not groups:
            return t
        x, back = self._staged(t)
        if x.data_ptr() == t.data_ptr():  # not staged: reduce into a copy
            x = x.clone()
        if len(axes) == len(self.axis_names) and self.backend is not None:
            groups = [dist.group.WORLD]  # every axis: one call on the world
        for g in groups:
            dist.all_reduce(x, op=op, group=g)
        return back(x)

    def psum(self, t: torch.Tensor, axis: str | Sequence[str]) -> torch.Tensor:
        """Sum of the members' ``t`` over ``axis`` (or several axes)."""
        return self._reduce(t, axis, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor, axis: str | Sequence[str]) -> torch.Tensor:
        """Elementwise max of the members' ``t`` over ``axis`` (or several)."""
        return self._reduce(t, axis, dist.ReduceOp.MAX)

    def ppermute(self, t: torch.Tensor, axis: str,
                 perm: Sequence[tuple[int, int]]) -> torch.Tensor:
        """``lax.ppermute``: for each (src, dst) pair of axis indices, the
        member at src sends ``t`` to the member at dst. A member no pair
        sends to receives zeros."""
        me = self.index(axis)
        ranks = self._ranks[axis]
        dsts = [d for s, d in perm if s == me]
        srcs = [s for s, d in perm if d == me]
        if len(srcs) > 1 or len(dsts) > 1:
            raise ValueError(f"perm {perm} is not a permutation")
        out = torch.zeros_like(t)
        x, back = self._staged(t)
        buf = torch.empty_like(x)
        ops = []
        if dsts and dsts[0] != me:
            ops.append(dist.P2POp(dist.isend, x, ranks[dsts[0]]))
        if srcs and srcs[0] != me:
            ops.append(dist.P2POp(dist.irecv, buf, ranks[srcs[0]]))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        if srcs:
            out.copy_(t if srcs[0] == me else back(buf))
        return out

    def barrier(self) -> None:
        if self.backend is not None and self.world > 1:
            dist.barrier()


def make_mesh(data: int | None = None, model: int = 1) -> Mesh:
    """The (data, model) mesh over the ranks of the process group (one
    rank without one). ``data`` defaults to world // model; raises
    ValueError when data · model is not the world size."""
    world = dist.get_world_size() if process_group_ready() else 1
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} devices")
    return Mesh(((DATA_AXIS, data), (MODEL_AXIS, model)))
