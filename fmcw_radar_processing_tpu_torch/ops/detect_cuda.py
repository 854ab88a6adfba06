"""K7: the peak search of the materializing frame chain (impl "pallas").

:func:`search_peaks_fused` launches the CUDA kernel of ``csrc/detect.cu``
(which replaces the JAX package's Pallas
``ops/detect_pallas.py::_kernel``) for CUDA tensors and runs the plain
PyTorch version :func:`search_peaks_fused_ref` for CPU tensors; on a CUDA
tensor it launches or raises.

Both compute the Pallas kernel's T-round algorithm — max, lowest-bin
argmax, mask — rather than ``dsp/detection.py``'s sort. The two agree on
every valid slot; on a slot with no target left the rounds give idx 0 (every
bin is −inf and the lowest wins), where a sort gives its own order of the
−inf bins. The Doppler gather and the strongest-chirp gather read those
indices, so the "pallas" chain keeps the kernel's choice.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fmcw_radar_processing_tpu_torch.config import RadarConfig
from fmcw_radar_processing_tpu_torch.dsp.detection import (
    DetectionResult,
    gate_mask,
    masked_peaks,
)
from fmcw_radar_processing_tpu_torch.ops import _lib

KERNEL_BINS = (128, 256, 512, 1024)  # K the kernel is built for (32·4·2^n)


@functools.lru_cache(maxsize=8)
def _launch_args(cfg: RadarConfig, device: torch.device
                 ) -> tuple[torch.Tensor, float, int]:
    """The kernel's config-derived arguments, made once per (config,
    device): the distance gate [K] as float32 on device (1 inside, 0
    outside), the float32 threshold and T."""
    gate = torch.as_tensor(gate_mask(cfg).astype(np.float32), device=device)
    return (gate, float(np.float32(cfg.algorithm.range_threshold)),
            cfg.algorithm.max_num_targets)


def search_peaks_fused_ref(profile: torch.Tensor,
                           cfg: RadarConfig) -> DetectionResult:
    """Plain version of K7. profile: [F, K] float32 → DetectionResult [F, T]."""
    k = profile.shape[-1]
    neg = torch.tensor(-torch.inf, dtype=torch.float32, device=profile.device)
    masked = masked_peaks(profile, cfg)
    cols = torch.arange(k, device=profile.device)
    idx, mag = [], []
    for t in range(cfg.algorithm.max_num_targets):
        best = masked.amax(dim=1, keepdim=True)
        best_idx = torch.where(masked == best, cols, k).amin(dim=1, keepdim=True)
        mag.append(best)
        idx.append(torch.where(best_idx < k, best_idx, 0))
        masked = torch.where(cols == best_idx, neg, masked)
    mag = torch.cat(mag, dim=1)
    valid = torch.isfinite(mag)
    return DetectionResult(idx=torch.cat(idx, dim=1).to(torch.int32),
                           magnitude=torch.where(valid, mag, 0.0), valid=valid)


def search_peaks_fused(profile: torch.Tensor,
                       cfg: RadarConfig) -> DetectionResult:
    """Peak search of a profile [F, K] → DetectionResult, each [F, T].

    CPU tensors: the plain version. CUDA tensors: the K7 kernel.
    """
    if profile.device.type == "cpu":
        return search_peaks_fused_ref(profile, cfg)
    lib = _lib.load_kernels()
    f, k = profile.shape
    if k not in KERNEL_BINS:
        raise ValueError(f"the peak-search kernel takes K in {KERNEL_BINS}, "
                         f"got {k}")
    _lib.check_operand("profile", profile, profile.device, torch.float32)
    gate, threshold, t = _launch_args(cfg, profile.device)
    idx = torch.empty((f, t), dtype=torch.int32, device=profile.device)
    mag = torch.empty((f, t), dtype=torch.float32, device=profile.device)
    valid = torch.empty((f, t), dtype=torch.bool, device=profile.device)
    if f == 0 or t == 0:
        return DetectionResult(idx=idx, magnitude=mag, valid=valid)
    stream = torch.cuda.current_stream(profile.device).cuda_stream
    rc = lib.search_peaks_launch(profile.data_ptr(), gate.data_ptr(),
                                 threshold, f, k, t, idx.data_ptr(),
                                 mag.data_ptr(), valid.data_ptr(), stream)
    _lib.check_launch("search_peaks_fused", rc)
    return DetectionResult(idx=idx, magnitude=mag, valid=valid)
