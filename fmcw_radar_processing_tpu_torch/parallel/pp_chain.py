"""Pipeline-parallel frame chain: the chain's two halves on two ranks.

The reference has no pipeline parallelism (radar_processing.m:197 is one
serial loop). This is the JAX package's ``parallel/pp_chain.py``: a
GPipe microbatch rotation over a ``stage`` axis, each microbatch's
activations moving one stage to the right by :meth:`Mesh.ppermute` every
tick.

  stage 0  fast time: calibration, DC removal, window, range-DFT product
           (radar_processing.m:201-207)              → rf [mb, PN, K, 2]
  stage 1  detection, the Doppler product at the detected bins,
           measurements and the strongest chirp row (:210-259)

Schedule: M microbatches over M+1 ticks. At tick t stage 0 transforms
microbatch t (t < M) while stage 1 consumes microbatch t−1 (t ≥ 1). The
outputs accumulate on the last stage and are replicated with one psum over
``stage`` (the other stage contributes zeros; bools ride as int32, and
NaN-filled slots stay NaN). ``stage`` composes with ``data``: frames shard
over ``data`` and each data shard pipelines over ``stage``. In the
multi-controller form each rank runs only its own stage's work. The
products are the plain float32 operators (dsp/fast_time.py::
FastTimeOperator), as JAX's are XLA: no kernel runs here.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from fmcw_radar_processing_tpu_torch.config import RadarConfig
from fmcw_radar_processing_tpu_torch.dsp.detection import (
    DetectionResult,
    search_peaks,
)
from fmcw_radar_processing_tpu_torch.dsp.fast_time import (
    FastTimeOperator,
    range_profile,
)
from fmcw_radar_processing_tpu_torch.dsp.slow_time import (
    DopplerPeaks,
    SlowTimeOperator,
    doppler_at_bins,
    doppler_peaks_at,
    measurements,
)
from fmcw_radar_processing_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    process_group_ready,
)
from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import FrameChainOutputs
from fmcw_radar_processing_tpu_torch.utils.cplx import resolve_device

STAGE_AXIS = "stage"
NUM_STAGES = 2


def make_pp_mesh(n_devices: int | None = None) -> Mesh:
    """(data, stage) mesh over the process group's ranks, with a 2-rank
    stage axis. ``n_devices`` (default: the world size) must be a
    multiple of 2 and the world size."""
    world = dist.get_world_size() if process_group_ready() else 1
    n = world if n_devices is None else n_devices
    if n % NUM_STAGES:
        raise ValueError(f"need a multiple of {NUM_STAGES} devices, have {n}")
    if n != world:
        raise ValueError(f"{n} devices asked, the process group has {world}")
    return Mesh(((DATA_AXIS, n // NUM_STAGES), (STAGE_AXIS, NUM_STAGES)))


def make_pp_frame_chain(
    cfg: RadarConfig, mesh: Mesh, num_microbatches: int = 4,
    device: torch.device | str = "cuda",
) -> Callable[[torch.Tensor, torch.Tensor], FrameChainOutputs]:
    """The pipeline-parallel chain over a mesh with a ``stage`` axis, on
    ``device`` (the card unless the caller asks for "cpu").

    Returns fn(raw, calib) -> FrameChainOutputs, numerically the single
    device's ``make_frame_chain(cfg, impl="xla")``: raw is this rank's
    data shard [F/dp, PN, NTS, 2] or [F/dp, PN, 2·NTS] (the same on both
    stages; only stage 0 reads it), calib [NTS, 2]; the outputs are the
    data shard's, on both stages. Raises ValueError for a mesh without a
    2-rank ``stage`` axis, and at the call when F/dp does not divide by
    ``num_microbatches``.
    """
    if STAGE_AXIS not in mesh.axis_names:
        raise ValueError(f"mesh needs a {STAGE_AXIS!r} axis: {mesh.axis_names}")
    if mesh.shape[STAGE_AXIS] != NUM_STAGES:
        raise ValueError(f"stage axis must have {NUM_STAGES} devices, "
                         f"got {mesh.shape[STAGE_AXIS]}")
    device = resolve_device(device)
    ft = FastTimeOperator.create(cfg, device)
    st = SlowTimeOperator.create(cfg, device)
    pn, nts, k = cfg.pn, cfg.nts, cfg.range_fft_size
    m = num_microbatches
    stage = mesh.index(STAGE_AXIS)

    def slow_stage(rf: torch.Tensor) -> tuple:
        """Stage 1: everything downstream of the range FFT."""
        profile = range_profile(rf)  # [mb, K]
        det = search_peaks(profile, cfg)  # [mb, T]
        rd_rows = doppler_at_bins(st, rf, det.idx)  # [mb, T, D, 2]
        dop = doppler_peaks_at(rd_rows, cfg)
        meas = measurements(det, dop, cfg)
        at = det.idx[:, 0].to(torch.int64)[:, None, None, None]
        strongest = torch.gather(rf, 2, at.expand(rf.shape[0], pn, 1, 2))[:, :, 0]
        return (profile, det.idx, det.magnitude, det.valid.to(torch.int32),
                dop.doppler_idx, dop.speed, meas.strength, meas.range,
                meas.speed, strongest, det.valid[:, 0].to(torch.int32))

    def chain(raw: torch.Tensor, calib: torch.Tensor) -> FrameChainOutputs:
        raw = torch.as_tensor(raw, dtype=torch.float32, device=device)
        raw = raw.reshape(raw.shape[0], pn, nts, 2)
        calib = torch.as_tensor(calib, dtype=torch.float32, device=device)
        f_local = raw.shape[0]
        if f_local % m:
            raise ValueError(f"frames/data-shard ({f_local}) must divide by "
                             f"num_microbatches ({m})")
        mb = f_local // m
        t_cap = cfg.algorithm.max_num_targets
        f32, i32 = torch.float32, torch.int32
        # [M, ...] accumulators, in slow_stage's order; bools as int32.
        shapes = [((mb, k), f32), ((mb, t_cap), i32), ((mb, t_cap), f32),
                  ((mb, t_cap), i32), ((mb, t_cap), i32), ((mb, t_cap), f32),
                  ((t_cap, mb), f32), ((t_cap, mb), f32), ((t_cap, mb), f32),
                  ((mb, pn, 2), f32), ((mb,), i32)]
        acc = [torch.zeros((m, *s), dtype=d, device=device) for s, d in shapes]
        buf = torch.zeros((mb, pn, k, 2), dtype=f32, device=device)
        for t in range(m + 1):
            # Stage 0 transforms microbatch t while t < M.
            if stage == 0 and t < m:
                send = ft(raw[t * mb:(t + 1) * mb], calib)  # [mb, PN, K, 2]
            else:
                send = torch.zeros_like(buf)
            # Stage 1 consumes microbatch t−1 from the previous tick.
            if stage == NUM_STAGES - 1 and t >= 1:
                for a, o in zip(acc, slow_stage(buf)):
                    a[t - 1] = o
            # Rotate the activations one stage to the right (tick M's would
            # carry only stage 0's zeros to no one, so it is not sent).
            if t < m:
                buf = mesh.ppermute(send, STAGE_AXIS,
                                    [(i, i + 1) for i in range(NUM_STAGES - 1)])
        # Replicate the last stage's results over ``stage``.
        (waterfall, didx, dmag, dvalid, dop_idx, dop_speed, strength, rng_m,
         speed, strongest, detected) = (mesh.psum(a, STAGE_AXIS) for a in acc)

        def frames_first(a):  # [M, mb, ...] → [F_local, ...]
            return a.reshape(f_local, *a.shape[2:])

        def targets_first(a):  # [M, T, mb] → [T, F_local]
            return a.transpose(0, 1).reshape(t_cap, f_local)

        return FrameChainOutputs(
            waterfall=frames_first(waterfall),
            detection=DetectionResult(idx=frames_first(didx),
                                      magnitude=frames_first(dmag),
                                      valid=frames_first(dvalid).to(torch.bool)),
            doppler=DopplerPeaks(doppler_idx=frames_first(dop_idx),
                                 speed=frames_first(dop_speed)),
            strength=targets_first(strength),
            range=targets_first(rng_m),
            speed=targets_first(speed),
            strongest_chirps=frames_first(strongest),
            detected=frames_first(detected).to(torch.bool),
            range_fft=None,
        )

    return chain
