"""The long-signal recording export over a mesh — the sp integration.

The reference's STFT is one serial ``spectrogram`` call over the whole
concatenated slow-time signal (radar_processing.m:270-299). Here the whole
export runs sharded over the ``data`` axis, as the JAX package's
``parallel/sp_recording.py`` does:

  1. the data-parallel chain (parallel/sharded_chain.py: kernel K1a on
     each rank's frames on the card) gives per-frame outputs sharded over
     frames, with no communication;
  2. the *global* slow-time packing: the stable partition runs over the
     whole frame axis. Each rank packs its own detected frames; an
     all-gather of the per-rank counts (the pipeline's single host sync)
     gives each rank its offset in the global packed signal, and an
     all-gather of the packed magnitudes lets each rank cut its chunk
     [index·L/n, (index+1)·L/n) — element for element the single-device
     pack (pipeline/frame_chain.py::pack_slow_time);
  3. :class:`ShardedStft` computes each rank's columns with the 19-sample
     halo and the global dB max;
  4. the log-frequency rescale is a per-column contraction, so it runs on
     each rank's columns: the [1024, L] intensity is made distributed;
  5. every rank assembles the JSON payload from the gathered arrays
     (parallel/multihost.py::gather_to_all).
"""

from __future__ import annotations

import numpy as np
import torch

from fmcw_radar_processing_tpu_torch.config import RadarConfig
from fmcw_radar_processing_tpu_torch.dsp.stft import (
    StftOperator,
    log_bins_axis,
    log_frequency_rescale,
    stft_frame_count,
)
from fmcw_radar_processing_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from fmcw_radar_processing_tpu_torch.parallel.multihost import (
    distribute_frames,
    gather_to_all,
)
from fmcw_radar_processing_tpu_torch.parallel.sharded_chain import (
    make_sharded_frame_chain,
)
from fmcw_radar_processing_tpu_torch.parallel.sharded_stft import ShardedStft
from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import pack_slow_time
from fmcw_radar_processing_tpu_torch.pipeline.payloads import spectrogram_payload
from fmcw_radar_processing_tpu_torch.utils.cplx import (
    pair_abs,
    resolve_device,
    to_pair,
)


class ShardedRecordingPipeline:
    """Mesh-wide recording → spectrogram-payload pipeline on ``device``
    (the card unless the caller asks for "cpu").

    The single-device equivalent is ``RadarPipeline.process_recording``
    (pipeline/recording.py); the outputs match it numerically. Raises
    ValueError without a fixed ``stft_nfft`` (the fidelity profile's
    next-pow-2 bucket depends on the data) and for ``stft_hop`` ≠ 1 (the
    sharded STFT is hop 1).
    """

    def __init__(self, cfg: RadarConfig, mesh: Mesh,
                 filename: str = "radar_data",
                 device: torch.device | str = "cuda"):
        a = cfg.algorithm
        if a.stft_nfft is None:
            raise ValueError(
                "ShardedRecordingPipeline needs a fixed stft_nfft "
                "(fidelity-mode next-pow-2 bucketing is data-dependent)")
        if (a.stft_hop or 1) != 1:
            raise ValueError(f"ShardedRecordingPipeline is hop 1, got "
                             f"stft_hop={a.stft_hop}")
        self.cfg = cfg
        self.mesh = mesh
        self.filename = filename
        self.device = resolve_device(device)
        self.chain = make_sharded_frame_chain(cfg, mesh, self.device)
        self.op = StftOperator.create(
            window_length=a.stft_window_length, beta=a.stft_kaiser_beta,
            nfft=a.stft_nfft, fs=1.0 / cfg.derived.prt, hop=1,
            precision=a.matmul_precision)
        self.stft = ShardedStft(op=self.op, mesh=mesh)

    def pack(self, strongest_chirps: torch.Tensor,
             detected: torch.Tensor) -> tuple[torch.Tensor, int]:
        """The global stable partition of the detected frames' chirp rows:
        (this rank's chunk of |packed signal| [F/n·PN], global valid count
        as a host int)."""
        mesh, pn = self.mesh, self.cfg.pn
        sig, n_det = pack_slow_time(strongest_chirps, detected, pn)
        mag = pair_abs(sig)  # [F/n·PN], this rank's valid prefix first
        counts = mesh.all_gather(n_det.reshape(1), DATA_AXIS).tolist()
        chunk = mag.shape[0]
        parts = mesh.all_gather(mag, DATA_AXIS)  # every rank's packed buffer
        total = sum(counts)
        packed = torch.cat([parts[r * chunk:r * chunk + c]
                            for r, c in enumerate(counts)]
                           + [parts.new_zeros(chunk * len(counts) - total)])
        i = mesh.index(DATA_AXIS)
        return packed[i * chunk:(i + 1) * chunk], total

    def process(self, raw: np.ndarray, calib: np.ndarray,
                local: bool = False) -> dict:
        """Run the full sharded export on this rank.

        raw: [F, PN, NTS, 2] float32 pairs, [F, PN, 2·NTS] flat pair rows
        or complex [F, PN, NTS] — the whole recording (F divisible by the
        data-axis size), or with ``local`` this rank's frame shard; calib:
        [NTS, 2] pair or [NTS] complex. Returns, on every rank, a dict with
        the gathered waterfall and measurements and the spectrogram
        payload.
        """
        cfg = self.cfg
        a = cfg.algorithm
        if np.iscomplexobj(raw):
            raw = to_pair(np.asarray(raw))
        calib = np.asarray(calib)
        if np.iscomplexobj(calib) or calib.ndim == 1:
            calib = to_pair(calib)
        raw_l = distribute_frames(raw, self.mesh, self.device, local=local)
        out = self.chain(raw_l, calib)
        sig, count = self.pack(out.strongest_chirps, out.detected)
        wl = self.op.window_length
        arrays = {"waterfall": out.waterfall, "range": out.range,
                  "speed": out.speed, "detected": out.detected}
        if count < wl:
            n_valid = 0
        else:
            _, arrays["db"], _ = self.stft(sig, count)
            # Per-column contraction: each rank rescales its own columns.
            _, arrays["intensity"] = log_frequency_rescale(
                self.stft.freqs, arrays["db"], a.max_freq_bins,
                precision=a.rescale_precision, method=a.rescale_method)
            n_valid = stft_frame_count(count, wl, self.op.hop)
        gathered = gather_to_all(arrays, self.mesh,
                                 dims={"range": 1, "speed": 1, "db": 1,
                                       "intensity": 1})
        db = gathered.get("db", np.zeros((self.op.num_bins, 0), np.float32))
        intensity = gathered.get("intensity",
                                 np.zeros((a.max_freq_bins, 0), np.float32))
        times = self.stft.times(sig.shape[0] * self.mesh.shape[DATA_AXIS])
        times = times[:n_valid]
        log_bins = log_bins_axis(self.stft.freqs, a.max_freq_bins)
        payload = spectrogram_payload(times, log_bins, intensity[:, :n_valid])
        return {
            "waterfall": gathered["waterfall"].T,  # (K, F) as RadarPipeline
            "range": gathered["range"],
            "speed": gathered["speed"],
            "detected": gathered["detected"],
            "spectrogram_db": db[:, :n_valid],
            "spectrogram_intensity": intensity[:, :n_valid],
            "spectrogram_times": times,
            "payload": payload,
        }
