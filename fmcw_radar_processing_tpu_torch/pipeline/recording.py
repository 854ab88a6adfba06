"""Recording pipelines — the reference's ``radar_processing('no')`` and
``radar_processing('yes')``.

Host/device split, as in the JAX package: the per-frame chain, packing and
the spectrogram export run on ``device``; the host reads back the
slow-time valid count once per spectrogram (the STFT's nfft is
2^nextpow2 of it in the reference, radar_processing.m:273, unless the
config pins it) and then assembles the JSON payloads from the final
arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fmcw_radar_processing_tpu_torch.config import RadarConfig
from fmcw_radar_processing_tpu_torch.config.radar import next_pow2
from fmcw_radar_processing_tpu_torch.dsp.fast_time import PackedFastTime
from fmcw_radar_processing_tpu_torch.dsp.stft import (
    StftOperator,
    decode_db_int8,
    log_bins_axis,
    log_frequency_rescale,
    psd_db,
    quantize_db_int8,
    resolve_stft_impl,
    stft_frame_count,
)
from fmcw_radar_processing_tpu_torch.ops.stft_cuda import spectrogram
from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import (
    FrameChainOutputs,
    make_frame_chain,
    pack_slow_time,
)
from fmcw_radar_processing_tpu_torch.pipeline.payloads import (
    fft_snapshot_payload,
    range_fft_payload,
    range_speed_payload,
    spectrogram_payload,
)
from fmcw_radar_processing_tpu_torch.utils.cplx import (
    pair_abs,
    pin_f32_matmul,
    resolve_device,
    to_pair,
)
from fmcw_radar_processing_tpu_torch.utils.observe import NullTimer

_STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}


def _normalize_raw(raw: np.ndarray, nts: int) -> np.ndarray:
    """Normalize any accepted raw layout to flat pair rows [F, PN, 2·NTS].

    Accepted: complex [F, PN, NTS], real [F, PN, NTS], pair
    [F, PN, NTS, 2], or already-flat [F, PN, 2·NTS]."""
    raw = np.asarray(raw)
    if np.iscomplexobj(raw):
        raw = to_pair(raw)
    elif raw.ndim == 3 and raw.shape[-1] == nts:
        raw = to_pair(raw)  # real samples: imag = 0
    elif raw.ndim == 3 and raw.shape[-1] != 2 * nts:
        raise ValueError(
            f"ndim-3 raw last dim {raw.shape[-1]} is neither NTS={nts} "
            f"(samples) nor 2·NTS={2 * nts} (flat pair-rows)"
        )
    if raw.ndim == 4 and raw.shape[-1] == 2:
        raw = raw.reshape(*raw.shape[:2], -1)
    return raw


@dataclasses.dataclass
class RecordingOutputs:
    """Full-recording ('no') mode results (arrays host-side NumPy)."""

    waterfall: np.ndarray  # (K, F)
    target_range: np.ndarray  # (T, F) NaN-filled
    target_speed: np.ndarray  # (T, F)
    target_strength: np.ndarray  # (T, F)
    detected: np.ndarray  # (F,) bool
    spectrogram_times: np.ndarray  # (T_stft,)
    spectrogram_freqs: np.ndarray  # (1024,) log-spaced
    spectrogram_intensity: np.ndarray  # (1024, T_stft) dB
    # Linear-frequency dB PSD — what the reference's PNG renders
    # (surf(T, F, psd) at radar_processing.m:331-340).
    spectrogram_linear_freqs: np.ndarray  # (nb,) uniform one-sided axis
    spectrogram_psd_db: np.ndarray  # (nb, T_stft) dB
    payloads: dict[str, dict]  # name -> payload dict (4 schemas)


@dataclasses.dataclass
class ActivityBatchOutput:
    """One activity-mode ('yes') batch spectrogram (radar_processing.m:444-607)."""

    batch: int  # 1-based batch number
    start_frame: int  # 1-based inclusive
    end_frame: int  # 1-based inclusive
    payload: dict
    filename: str


class RadarPipeline:
    """The recording pipeline for a fixed RadarConfig on one device.

    device: "cuda" by default; "cpu" runs the kernels' plain versions.
    Raises RuntimeError for "cuda" without a card.

    impl: the frame chain's formulation (pipeline/frame_chain.py), any of
    the JAX package's names: "auto" (the profile chain: bf16x3 K1a on the
    card, the exact plain version on the CPU), "pallas_profile" (exact,
    K1b), "pallas_profile_high" (bf16x3, K1a), "pallas_profile_bf16" (one
    bf16 pass, K1c), "pallas" (the materializing chain, K6 + K7), and the
    plain formulations "fused", "fused_bf16" and "xla".

    The export follows ``AlgorithmConfig.stft_impl``
    (dsp/stft.py::resolve_stft_impl): the export kernels for "auto" at hop
    1 and for "pallas", the plain composition otherwise.
    """

    def __init__(self, cfg: RadarConfig, filename: str = "radar_data",
                 device: torch.device | str = "cuda", impl: str = "auto"):
        self.device = resolve_device(device)
        pin_f32_matmul()
        self.cfg = cfg
        self.filename = filename
        self._chain = make_frame_chain(cfg, self.device, impl=impl)

    def _device_inputs(self, raw: np.ndarray, calib: np.ndarray):
        """raw as flat pair rows [F, PN, 2·NTS] and calib as a pair
        [NTS, 2], float32 on the pipeline's device."""
        raw = _normalize_raw(raw, self.cfg.nts)
        calib = np.asarray(calib)
        if np.iscomplexobj(calib) or calib.ndim == 1:
            calib = to_pair(calib)
        return (torch.as_tensor(raw, dtype=torch.float32).to(self.device),
                torch.as_tensor(calib, dtype=torch.float32).to(self.device))

    def run_chain(self, raw: np.ndarray, calib: np.ndarray) -> FrameChainOutputs:
        """Run the per-frame chain.

        raw: [F, PN, NTS] complex, pair [F, PN, NTS, 2] float32, or flat
        pair rows [F, PN, 2·NTS]; calib: [NTS] complex or [NTS, 2] pair.
        """
        return self._chain(*self._device_inputs(raw, calib))

    def _spectrogram_of_signal(self, signal: torch.Tensor, count: int,
                               timer=None):
        """STFT export of a packed slow-time signal (first ``count`` samples
        valid): (times, log_bins, intensity, freqs, db) as NumPy arrays
        trimmed to the valid columns, or None if shorter than one window.

        timer stages: "stft" (the device export, synced) and "host_decode"
        (device-to-host copies and widening to float32)."""
        tm = timer if timer is not None else NullTimer()
        a = self.cfg.algorithm
        wl = a.stft_window_length
        if count < wl:
            return None
        op = StftOperator.create(
            window_length=wl, beta=a.stft_kaiser_beta,
            nfft=a.stft_nfft or next_pow2(count),  # the nfft bucket (:273)
            fs=1.0 / self.cfg.derived.prt, hop=a.stft_hop or 1,
            precision=a.matmul_precision)
        kernels = resolve_stft_impl(a.stft_impl, op.hop) == "pallas"
        n_valid = stft_frame_count(count, wl, op.hop)
        int_dtype = _STORE_DTYPES[a.intensity_dtype]
        db_store = _STORE_DTYPES[a.stft_db_store]
        psd_store = (torch.bfloat16 if a.stft_psd_store == "bfloat16"
                     else torch.float32)
        psd_precision = a.stft_psd_precision
        if -(-op.num_bins // 8) * 8 > 512:
            # The JAX package's rule (its resolves_tiled): past 512 bins its
            # export is the bin-blocked exact float32 path, whatever the
            # config asks. Which kernels run here is spectrogram()'s own gate.
            db_store = psd_store = torch.float32
            psd_precision = "highest"
        freqs = (np.arange(op.num_bins, dtype=np.float32)
                 * np.float32(op.fs / op.nfft))
        with tm.stage("stft", items=count):
            # Reference: STFT of |slow_time| (radar_processing.m:270).
            sig = pair_abs(signal)
            if kernels:
                _, db, intensity = spectrogram(
                    sig, count, op, a.max_freq_bins, intensity_dtype=int_dtype,
                    db_store_dtype=db_store, psd_precision=psd_precision,
                    psd_store_dtype=psd_store)
            else:
                # The JAX package's XLA branch (stft_impl "xla", and "auto"
                # at hop ≠ 1): the operator product, the float32 dB map
                # (whatever stft_db_store says), the rescale, then the cast.
                db = psd_db(op(sig, valid_len=count).power)
                _, intensity = log_frequency_rescale(
                    freqs, db, a.max_freq_bins, precision=a.rescale_precision,
                    method=a.rescale_method)
                intensity = (quantize_db_int8(intensity) if int_dtype == torch.int8
                             else intensity.to(int_dtype))
            tm.observe((db, intensity))
        with tm.stage("host_decode", items=n_valid):
            intensity = intensity[:, :n_valid].cpu()
            if a.intensity_dtype == "int8":
                intensity_np = decode_db_int8(intensity)
            else:  # bf16/f32 copied in the store dtype, widened on the host
                intensity_np = intensity.to(torch.float32).numpy()
            db_np = db[:, :n_valid].cpu().to(torch.float32).numpy()
        # Segment-centre times (t·hop + W/2)/fs, × the float32 reciprocal of
        # fs: what XLA makes of the JAX package's division by a constant.
        times = ((np.arange(n_valid, dtype=np.float32) * np.float32(op.hop)
                  + np.float32(wl / 2.0))
                 * (np.float32(1.0) / np.float32(op.fs)))
        return (times, log_bins_axis(freqs, a.max_freq_bins), intensity_np,
                freqs, db_np)

    def process_recording(self, raw: np.ndarray, calib: np.ndarray,
                          timer=None) -> RecordingOutputs:
        """Full-recording mode — radar_processing('no') (:195-436).

        timer: optional utils.observe.StageTimer — records per-stage,
        device-synced wall times (frame_chain / stft / host_decode /
        payload_build).
        """
        tm = timer if timer is not None else NullTimer()
        cfg = self.cfg
        with tm.stage("frame_chain", items=raw.shape[0]):
            out = self.run_chain(raw, calib)
            signal, count_dev = pack_slow_time(out.strongest_chirps,
                                               out.detected, cfg.pn)
            count = int(count_dev)  # the single host sync of the pipeline

        spec = self._spectrogram_of_signal(signal, count, tm)
        if spec is None:
            times = np.zeros(0)
            log_bins = np.zeros(cfg.algorithm.max_freq_bins)
            intensity = np.zeros((cfg.algorithm.max_freq_bins, 0))
            lin_freqs = np.zeros(0)
            psd = np.zeros((0, 0))
        else:
            times, log_bins, intensity, lin_freqs, psd = spec

        with tm.stage("payload_build"):
            waterfall = out.waterfall.cpu().numpy().T  # (K, F)
            t_range = out.range.cpu().numpy()
            t_speed = out.speed.cpu().numpy()
            t_strength = out.strength.cpu().numpy()
            detected = out.detected.cpu().numpy()
            literal_mag = None
            if cfg.algorithm.compat_linear_index_snapshot:
                literal_mag = self._literal_snapshot_magnitude(raw, calib)
            payloads = {
                "spectrogram_data.json": spectrogram_payload(
                    times, log_bins, intensity
                ),
                f"{self.filename}_range_fft_data.json": range_fft_payload(
                    waterfall, cfg, self.filename
                ),
                f"{self.filename}_range_speed_data.json": range_speed_payload(
                    t_range, t_speed, cfg, self.filename
                ),
                f"{self.filename}_fft_data.json": fft_snapshot_payload(
                    waterfall, cfg, self.filename,
                    literal_chirp_magnitude=literal_mag,
                ),
            }
        return RecordingOutputs(
            waterfall=waterfall,
            target_range=t_range,
            target_speed=t_speed,
            target_strength=t_strength,
            detected=detected,
            spectrogram_times=times,
            spectrogram_freqs=log_bins,
            spectrogram_intensity=intensity,
            spectrogram_linear_freqs=lin_freqs,
            spectrogram_psd_db=psd,
            payloads=payloads,
        )

    def _literal_snapshot_magnitude(self, raw: np.ndarray, calib: np.ndarray,
                                    chirp_1based: int = 100) -> np.ndarray:
        """Quirk #2 literal value (compat_linear_index_snapshot): |range
        FFT| of chirp #``chirp_1based`` overall — what MATLAB column-linear
        indexing of the (K, PN, F) cube returns for
        ``range_tx1rx1_complete(:, 100)`` (radar_processing.m:410-411).
        Recomputed for the one owning frame (the cube itself is never
        materialized)."""
        cfg = self.cfg
        raw = _normalize_raw(raw, cfg.nts)
        lin = min(chirp_1based - 1, raw.shape[0] * cfg.pn - 1)  # 0-based, clamped
        fr, ch = lin // cfg.pn, lin % cfg.pn
        raw_t, calib_t = self._device_inputs(raw[fr : fr + 1], calib)
        rf = PackedFastTime.create(cfg, self.device).rf(raw_t, calib_t)
        return pair_abs(rf[0, ch]).cpu().numpy()  # [K]

    def process_activity(self, raw: np.ndarray,
                         calib: np.ndarray) -> list[ActivityBatchOutput]:
        """Animal-activity batch mode — radar_processing('yes') (:440-607).

        Frames are processed in batches of ``batch_size`` (100); each batch
        with ≥ window_length slow-time samples yields one spectrogram JSON,
        capped at ``max_plots`` (4). The per-frame chain runs ONCE over the
        whole recording — only packing and the STFT are per batch.
        """
        cfg = self.cfg
        a = cfg.algorithm
        out = self.run_chain(raw, calib)
        f = raw.shape[0]
        results: list[ActivityBatchOutput] = []
        for b in range(-(-f // a.batch_size)):
            if len(results) >= a.max_plots:
                break  # :597-599
            start = b * a.batch_size
            end = min((b + 1) * a.batch_size, f)
            signal, count_dev = pack_slow_time(out.strongest_chirps[start:end],
                                               out.detected[start:end], cfg.pn)
            spec = self._spectrogram_of_signal(signal, int(count_dev))
            if spec is None:
                continue  # :534,601-606 insufficient data — no JSON
            times, log_bins, intensity = spec[:3]
            results.append(ActivityBatchOutput(
                batch=b + 1,
                start_frame=start + 1,
                end_frame=end,
                payload=spectrogram_payload(
                    times, log_bins, intensity, batch=b + 1,
                    start_frame=start + 1, end_frame=end,
                    filename_base=self.filename),
                filename=f"{self.filename}_spectrogram_batch_{b + 1}.json",
            ))
        return results
