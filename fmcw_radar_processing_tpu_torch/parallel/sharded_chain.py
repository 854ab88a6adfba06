"""Data-parallel frame chain: frames sharded over the mesh's ``data`` axis.

The per-frame chain (fast-time product → detection → Doppler product →
measurements) has no cross-frame coupling, so each rank runs the port's
``make_frame_chain`` on its own frames with zero communication; the
operator matrices are small and every rank builds its own. On a CUDA
device the chain's default impl launches kernel K1a on every rank. Only
the slow-time packing (a global prefix over the detected mask,
parallel/sp_recording.py) and the payload assembly
(parallel/multihost.py::gather_to_all) need the other ranks' data.
"""

from __future__ import annotations

from typing import Callable

import torch

from fmcw_radar_processing_tpu_torch.config import RadarConfig
from fmcw_radar_processing_tpu_torch.parallel.mesh import Mesh
from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import (
    FrameChainOutputs,
    make_frame_chain,
)
from fmcw_radar_processing_tpu_torch.utils.cplx import resolve_device


def make_sharded_frame_chain(
    cfg: RadarConfig, mesh: Mesh, device: torch.device | str = "cuda",
) -> Callable[[torch.Tensor, torch.Tensor], FrameChainOutputs]:
    """The chain with frames sharded over the ``data`` axis, on ``device``
    (the card unless the caller asks for "cpu").

    Returns fn(raw, calib) -> FrameChainOutputs: raw is this rank's frame
    shard [F/n, PN, 2·NTS] (or [F/n, PN, NTS, 2]; parallel/multihost.py::
    distribute_frames cuts it), calib [NTS, 2] the same on every rank; the
    outputs are this rank's shard of each per-frame output.
    """
    del mesh  # frames are independent: the shard is all a rank needs
    device = resolve_device(device)
    chain = make_frame_chain(cfg, device)
    pn = cfg.pn

    def sharded(raw: torch.Tensor, calib: torch.Tensor) -> FrameChainOutputs:
        raw = torch.as_tensor(raw, dtype=torch.float32, device=device)
        raw = raw.reshape(raw.shape[0], pn, -1)
        return chain(raw, torch.as_tensor(calib, dtype=torch.float32,
                                          device=device))

    return sharded
