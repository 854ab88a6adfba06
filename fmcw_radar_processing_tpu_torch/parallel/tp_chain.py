"""Tensor-parallel frame chain: range bins sharded over the ``model`` axis.

The reference has no tensor parallelism (its whole chain is one serial
MATLAB loop, radar_processing.m:197). This formulation, the JAX package's
``parallel/tp_chain.py``, shards the *output* axis of the fast-time DFT
product — the K = 256 range bins (radar_processing.m:118) — over ``model``:

  * the (K, NTS) fast-time operator is row-sharded, so each rank computes
    only its K/mp bins of the range FFT (a column-parallel Dense layer);
  * the max over chirps (radar_processing.m:210) is bin-local, so each
    rank integrates its own bins and one tiled all-gather of K/mp floats
    per frame assembles the profile that detection needs;
  * the Doppler stage needs the chirp rows at the detected bins only
    (radar_processing.m:216): the owning rank contributes each row, the
    others zeros, and one psum over ``model`` gives them to every rank.

Frames shard over ``data`` at the same time. The products are the plain
float32 operator (utils/cplx.py::pair_matmul), as JAX's are XLA: no
kernel runs here.
"""

from __future__ import annotations

from typing import Callable

import torch

from fmcw_radar_processing_tpu_torch.config import RadarConfig
from fmcw_radar_processing_tpu_torch.dsp.detection import search_peaks
from fmcw_radar_processing_tpu_torch.dsp.fast_time import FastTimeOperator
from fmcw_radar_processing_tpu_torch.dsp.slow_time import (
    SlowTimeOperator,
    doppler_peaks_at,
    measurements,
)
from fmcw_radar_processing_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import FrameChainOutputs
from fmcw_radar_processing_tpu_torch.utils.cplx import (
    pair_abs,
    pair_matmul,
    resolve_device,
)


def make_tp_frame_chain(
    cfg: RadarConfig, mesh: Mesh, device: torch.device | str = "cuda",
) -> Callable[[torch.Tensor, torch.Tensor], FrameChainOutputs]:
    """The (data, model)-sharded chain for a fixed config on ``device``
    (the card unless the caller asks for "cpu").

    Returns fn(raw, calib) -> FrameChainOutputs: raw is this rank's frame
    shard [F/dp, PN, NTS, 2] or [F/dp, PN, 2·NTS] (parallel/multihost.py::
    distribute_frames), calib [NTS, 2]; the outputs are the frame shard's,
    the same on every rank of a ``model`` group. Raises ValueError when
    K = range_fft_size does not divide by the ``model`` axis size.
    """
    device = resolve_device(device)
    mp = mesh.shape[MODEL_AXIS]
    k = cfg.range_fft_size
    if k % mp != 0:
        raise ValueError(f"range_fft_size {k} not divisible by model axis {mp}")
    kloc = k // mp
    lo = mesh.index(MODEL_AXIS) * kloc
    ft = FastTimeOperator.create(cfg, device)
    # This rank's rows of the fast-time matrix (build_fast_time_matrix).
    m_re_l = ft.m_re[lo:lo + kloc].contiguous()
    m_im_l = ft.m_im[lo:lo + kloc].contiguous()
    st = SlowTimeOperator.create(cfg, device)
    pn, nts = cfg.pn, cfg.nts

    def chain(raw: torch.Tensor, calib: torch.Tensor) -> FrameChainOutputs:
        raw = torch.as_tensor(raw, dtype=torch.float32, device=device)
        raw = raw.reshape(raw.shape[0], pn, nts, 2)
        calib = torch.as_tensor(calib, dtype=torch.float32, device=device)
        f = raw.shape[0]
        # The shard-local slice of the fast-time product.
        rf_l = (pair_matmul(raw, m_re_l, m_im_l, "...pn,kn->...pk")
                - pair_matmul(calib, m_re_l, m_im_l, "n,kn->k"))  # [f, PN, kloc, 2]
        # Bin-local integration, then one all-gather of the K-bin profile.
        profile_l = pair_abs(rf_l).amax(dim=-2)  # [f, kloc]
        profile = mesh.all_gather(profile_l, MODEL_AXIS, dim=-1)  # [f, K]
        det = search_peaks(profile, cfg)
        # Doppler rows at the detected bins: the owning rank's chirp rows,
        # zeros elsewhere, summed over ``model`` (radar_processing.m:216-219).
        lidx = det.idx.to(torch.int64) - lo
        owned = (lidx >= 0) & (lidx < kloc)  # [f, T]
        t = lidx.shape[-1]
        index = lidx.clamp(0, kloc - 1)[:, None, :, None].expand(f, pn, t, 2)
        rows = torch.gather(rf_l, 2, index).transpose(1, 2)  # [f, T, PN, 2]
        rows = torch.where(owned[..., None, None], rows, 0.0)
        rows = mesh.psum(rows, MODEL_AXIS)
        rd_rows = pair_matmul(rows, st.m_re_t, st.m_im_t, "...tp,dp->...td")
        dop = doppler_peaks_at(rd_rows, cfg)
        meas = measurements(det, dop, cfg)
        return FrameChainOutputs(
            waterfall=profile,
            detection=det,
            doppler=dop,
            strength=meas.strength,
            range=meas.range,
            speed=meas.speed,
            strongest_chirps=rows[:, 0],  # the strongest target's chirp row
            detected=det.valid[:, 0],
            range_fft=None,
        )

    return chain
