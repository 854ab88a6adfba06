"""Typed radar configuration.

Three tiers, mirroring the reference's config story
(`radar_processing.m:89-154` and the canonical commented-out schema at
`radar_processing.m:644-672`):

  * :class:`DeviceConfig`  — values parsed from the Infineon device XML
    (`radar_processing.m:94-115`).
  * :class:`AlgorithmConfig` — hard-coded algorithm settings
    (`radar_processing.m:117-129,136,177-190`).
  * :class:`DerivedParams` — theoretical values computed from the two above
    (`radar_processing.m:131-154`).

All three are frozen dataclasses so they hash: the kernel wrappers and
operator builders key their caches on them.

The port's own copy of the JAX package's ``config/radar.py``: the fields,
defaults, constants and ``production()`` are the numeric contract the two
packages share, and stay identical. The comments on the TPU-only settings
(MXU pass counts, the Pallas export) describe what each field selects in
the JAX package; the port reads only the fields its ported paths take.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Tuple

C0 = 3.0e8  # speed of light in vacuum [m/s] (radar_processing.m:67)


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """Radar device configuration (the XML schema of radar_processing.m:94-115)."""

    chirp_duration_ns: float  # BaseEndpoint.chirpDuration_ns
    lower_frequency_khz: float  # FmcwEndpoint.FmcwConfiguration.lowerFrequency_kHz
    upper_frequency_khz: float  # FmcwEndpoint.FmcwConfiguration.upperFrequency_kHz
    num_tx_antennas: int  # BaseEndpoint.DeviceInfo.numAntennasTx
    num_rx_antennas: int  # BaseEndpoint.DeviceInfo.numAntennasRx
    num_samples_per_chirp: int  # BaseEndpoint.FrameFormat.numSamplesPerChirp (NTS)
    num_chirps_per_frame: int  # BaseEndpoint.FrameFormat.numChirpsPerFrame (PN)
    samplerate_hz: float  # AdcxmcEndpoint.AdcxmcConfiguration.samplerateHz

    @property
    def nts(self) -> int:
        return self.num_samples_per_chirp

    @property
    def pn(self) -> int:
        return self.num_chirps_per_frame


@dataclasses.dataclass(frozen=True)
class AlgorithmConfig:
    """Algorithm settings (radar_processing.m:117-129,177-190).

    Defaults are the reference's hard-coded constants.  ``stft_hop`` and
    ``stft_nfft`` generalize the reference's pathological hop-1 /
    nfft=2^nextpow2(L) STFT (radar_processing.m:178-179,273): hop None means
    hop 1 and nfft None means next-pow-2 of the signal length (fidelity
    mode); production configs should set sane values.
    """

    range_fft_size: int = 256  # :118
    doppler_fft_size: int = 16  # :119
    range_threshold: float = 200.0  # :123
    doppler_threshold: float = 50.0  # :124
    min_distance: float = 0.9  # :126
    max_distance: float = 25.0  # :127
    max_num_targets: int = 1  # :129
    frame_time: float = 0.150  # :91 (s)
    down_chirp_duration: float = 200e-6  # :95
    chirp_to_chirp_delay: float = 300e-6  # :96
    stft_window_length: int = 20  # :178
    stft_kaiser_beta: float = 3.0  # kaiser(window_length, 3), :276
    stft_hop: int | None = None  # None => overlap = window-1 (hop 1), :179
    stft_nfft: int | None = None  # None => 2^nextpow2(len), :273
    max_freq_bins: int = 1024  # log-frequency output bins, :293
    batch_size: int = 100  # activity-mode frames per batch, :189
    max_plots: int = 4  # activity-mode spectrogram cap, :443
    # MXU pass count for f32 matmuls ("default" = 1 bf16 pass, "high" = 3,
    # "highest" = 6). TPU MXUs multiply in bfloat16; a nominally-f32 matmul
    # at DEFAULT precision quantizes both operands to 8-bit mantissas —
    # measured on a v5e this is what capped the chain's waterfall SNR at
    # ~55 dB and the spectrogram at ~36 dB vs the f64 oracle
    # (SNR_LADDER.json; the same code on CPU holds 140 dB). "highest"
    # recovers true f32 results; the throughput cost is recorded per
    # precision in BENCH_MATRIX.json. The bf16 impl variants are the
    # explicit speed knob and ignore this setting.
    matmul_precision: str = "highest"
    # Log-frequency rescale formulation: "matmul" (dense [1024, nb] MXU
    # contraction at rescale_precision — default) or "gather" (exact f32
    # lerp via two static row-gathers). Both raced on the v5e: the XLA
    # gather runs at 15.9 ms per 16k frames vs the matmul's 0.8/2.3/4.4 ms
    # at 1/3/6 MXU passes — TPU gathers neither tile nor pipeline, so the
    # dense form wins despite 400× the nominal FLOPs. Gather is kept for
    # CPU-targeted runs, where it is both exact and cheap.
    rescale_method: str = "matmul"
    # MXU pass count for the rescale contraction alone. It is the one
    # FLOPs-dense matmul of the chain (2·1024·129 per STFT column — the
    # DFT/STFT matmuls hide their extra passes under HBM traffic, measured
    # +0.2 ms at "highest"; the rescale does not). "high" (3-pass) keeps
    # the interpolation within 2^-21 relative — ≤ 5e-4 dB even at the
    # −1000 dB floor — for a third of "highest"'s cost.
    rescale_precision: str = "high"
    # Spectrogram-export implementation: "xla" = StftOperator + psd_db +
    # log_frequency_rescale (framed matmuls, works everywhere);
    # "pallas" = the fused two-phase kernel pair (ops/stft_pallas.py —
    # frame matrix and complex parts never reach HBM; TPU, hop-1 only);
    # "auto" = pallas on TPU when hop is 1, else xla.
    stft_impl: str = "auto"
    # Storage dtype of the [1024, T] log-frequency intensity map — the
    # single largest HBM tensor of the chain (~2/3 of its write traffic at
    # hop 1). "bfloat16" halves that traffic at a quantization cost of
    # ~±0.15 dB per bin (8-bit mantissa on dB values; SNR per variant
    # recorded in BENCH_MATRIX.json). "int8" quarters it: the kernel
    # epilogue emits an affine-quantized dB value over INT8_DB_RANGE
    # (chosen around the reference PNG's clim [−40, 0],
    # radar_processing.m:340 — step ≈ 0.165 dB ⇒ round-to-nearest error
    # ≤ 0.083 dB in-range, within the ≤ 0.15 dB display-band promotion
    # criterion; bins outside the range clamp, which only touches
    # sub-display values). Payloads are converted back to f32 on the host
    # either way.
    intensity_dtype: str = "float32"
    # MXU pass count of the fused Pallas export's phase-1 DFT dot
    # (ops/stft_pallas.py): "highest" = true f32 (6 passes) — the
    # fidelity default, so the bare AlgorithmConfig / MPS-parity serve
    # path emits oracle-grade artifacts; "high" = bf16x3 (3 passes,
    # ~2^-18 *absolute* PSD noise: µdB in the display band, up to ~0.5 dB
    # at deep spectral nulls). production() opts into "high" — measured
    # +8% end to end (BENCH_MATRIX r4) under the recorded display-band
    # criterion. Only consulted when the untiled materializing Pallas
    # export runs; the tiled (large-nfft) and recompute formulations are
    # HIGHEST-only.
    stft_psd_precision: str = "highest"
    # Storage dtype of the [nb, T] PSD round-trip between the fused
    # export's two kernel phases — pure inter-kernel traffic on a
    # bandwidth-bound chain. "bfloat16" halves it at ~2^-9 relative
    # (≤ ~0.034 dB measured through the dB map — p and gmax quantize
    # together). Untiled materializing Pallas path only; fidelity
    # default "float32".
    stft_psd_store: str = "float32"
    # Storage dtype of the [nb, T] dB map the export writes (consumed by
    # the host for the PNG/payloads; nothing re-reads it on device).
    # "bfloat16" halves that write at ≤ 0.125 dB quantization at the clim
    # edge — below one 8-bit color step of the reference PNG's 40 dB
    # range; DB_FLOOR is exactly bf16-representable so floor equality
    # survives. Untiled materializing Pallas path only.
    stft_db_store: str = "float32"
    # --- literal-compat flags (SURVEY Appendix A; default = intent) ---
    # Quirk #1: the 'no' branch writes target_measurements.(fr_idx, j) into
    # arrays preallocated zeros(T, F) (radar_processing.m:157-159 vs
    # :245-250) — MATLAB silently grows them, leaving measurements in
    # COLUMN j with zeros (not NaN) elsewhere. True replicates that literal
    # layout in the range_speed payload for byte-parity with a MATLAB run.
    compat_transposed_measurements: bool = False
    # Quirk #2: the fft_data snapshot indexes the 3-D (K, PN, F) FFT cube
    # with 2 subscripts (radar_processing.m:410-411) — MATLAB column-linear
    # indexing returns CHIRP #100 overall (frame 7, chirp 4 at PN=16), raw
    # complex column, not the frame-100 integrated profile. True replicates
    # the literal chirp column.
    compat_linear_index_snapshot: bool = False

    @classmethod
    def production(cls, **overrides) -> "AlgorithmConfig":
        """The measured production throughput profile (r4 matrix).

        Promotion criterion (recorded per VERDICT r3 item 1): the fastest
        grid point whose EXPORTED artifacts are each either ≥ 100 dB SNR
        vs the f64 oracle or display-band-bounded ≤ 0.15 dB at the
        reference's clim [−40, 0] (radar_processing.m:340). Winner
        (BENCH_MATRIX.json, v5e): chain impl ``pallas_profile_high``
        (bf16x3 — waterfall 110.1 dB, ranges exact) + fused Pallas export
        with the bf16x3 phase-1 PSD kernel (its ~2^-18 absolute PSD noise
        is µdB in the display band; only deep spectral nulls move) and
        kernel-emitted bf16 intensity — measured 4.87M frames/s with
        display-band err 0.125 dB, vs 3.48M for the all-f32 chain+export.
        The next-faster point (pallas_profile_bf16 + bf16 intensity)
        drops the exported waterfall to 55 dB and therefore stays opt-in
        rather than default. stft_nfft pins the 256-bucket (production
        STFT); the bare ``AlgorithmConfig()`` remains the
        reference-fidelity profile (hop-1, nfft = 2^nextpow2(L), f32
        artifacts) used by the MPS-parity serve path and the oracle tests.
        """
        base: dict = dict(stft_nfft=256, intensity_dtype="bfloat16",
                          stft_psd_precision="high",
                          stft_db_store="bfloat16")
        base.update(overrides)
        # (r5) stft_db_store="bfloat16" joined the profile: the exported
        # dB map is host-consumed only, so quantizing its STORE
        # (≤ 0.125 dB at the clim edge — under one PNG color step) leaves
        # the intensity artifact untouched (the in-kernel interpolation
        # consumes the f32 value) — measured +3% end to end.
        # stft_psd_store="bfloat16" (another ~+2%) was TRIED AND DEMOTED:
        # its display-band error rides the whole map through the gmax
        # normalization and, with the max-of-quantized-values
        # normalization (the correct invariant), measures a consistent
        # ~0.155 dB across a 3-seed workload sweep — OVER the 0.15
        # criterion (production itself holds a stable 0.1253–0.1254 on
        # the same sweep: the bf16-intensity hard bound). It remains an
        # explicit opt-in for display-tolerant deployments.
        return cls(**base)


@dataclasses.dataclass(frozen=True)
class DerivedParams:
    """Theoretical radar values (radar_processing.m:131-154)."""

    prt: float
    bandwidth: float
    carrier_frequency: float
    wavelength: float
    hz_to_mps: float
    if_scale: float
    r_max: float
    dist_per_bin: float
    fd_max: float
    fd_per_bin: float

    def range_axis(self, range_fft_size: int) -> Tuple[float, ...]:
        """array_bin_range (radar_processing.m:149): metres per range bin."""
        return tuple(i * self.dist_per_bin for i in range(range_fft_size))

    def speed_axis(self, doppler_fft_size: int) -> Tuple[float, ...]:
        """array_bin_fD (radar_processing.m:154): m/s per Doppler bin (1-based
        bin b maps to (b - N/2 - 1) * -fd_per_bin * lambda/2)."""
        half = doppler_fft_size // 2
        return tuple(
            (b - half - 1) * -self.fd_per_bin * self.hz_to_mps
            for b in range(1, doppler_fft_size + 1)
        )


def derive(dev: DeviceConfig, alg: AlgorithmConfig) -> DerivedParams:
    """Compute DerivedParams exactly as radar_processing.m:89-154 does."""
    up_chirp = dev.chirp_duration_ns * 1e-9
    prt = up_chirp + alg.down_chirp_duration + alg.chirp_to_chirp_delay  # :97
    bw = (dev.upper_frequency_khz - dev.lower_frequency_khz) * 1e3  # :100
    fc = (dev.upper_frequency_khz + dev.lower_frequency_khz) / 2.0 * 1e3  # :106
    lam = C0 / fc  # :133
    hz_to_mps = lam / 2.0  # :135
    if_scale = 16.0 * 3.3 * alg.range_fft_size / dev.nts  # :121,136
    r_max = dev.nts * C0 / (2.0 * bw)  # :142
    dist_per_bin = r_max / alg.range_fft_size  # :147
    fd_max = 1.0 / (2.0 * prt)  # :152
    fd_per_bin = fd_max / alg.doppler_fft_size  # :153
    return DerivedParams(
        prt=prt,
        bandwidth=bw,
        carrier_frequency=fc,
        wavelength=lam,
        hz_to_mps=hz_to_mps,
        if_scale=if_scale,
        r_max=r_max,
        dist_per_bin=dist_per_bin,
        fd_max=fd_max,
        fd_per_bin=fd_per_bin,
    )


@dataclasses.dataclass(frozen=True)
class RadarConfig:
    """Bundle of device + algorithm config with derived values (hashable)."""

    device: DeviceConfig
    algorithm: AlgorithmConfig
    derived: DerivedParams

    @classmethod
    def create(
        cls, device: DeviceConfig, algorithm: AlgorithmConfig | None = None
    ) -> "RadarConfig":
        algorithm = algorithm or AlgorithmConfig()
        return cls(device=device, algorithm=algorithm, derived=derive(device, algorithm))

    # Convenience accessors used throughout the DSP code
    @property
    def nts(self) -> int:
        return self.device.nts

    @property
    def pn(self) -> int:
        return self.device.pn

    @property
    def range_fft_size(self) -> int:
        return self.algorithm.range_fft_size

    @property
    def doppler_fft_size(self) -> int:
        return self.algorithm.doppler_fft_size

    @property
    def zero_doppler_bin(self) -> int:
        """0-based index of the zero-velocity bin after fftshift.

        The reference hard-codes 1-based bin 9 for doppler_fft_size=16
        (radar_processing.m:234-238); we derive it as N/2 (0-based), which
        equals 9 in 1-based indexing for N=16.
        """
        return self.doppler_fft_size // 2

    def to_json(self) -> str:
        """Export the canonical configuration schema.

        Field names follow the commented-out `fmcw_configurations` struct at
        radar_processing.m:644-672 so dashboards built against the reference
        schema keep working.
        """
        d = self.derived
        a = self.algorithm
        dev = self.device
        obj = {
            "frame_time": a.frame_time,
            "PRT": d.prt,
            "Bandwidth": d.bandwidth,
            "num_Tx_antennas": dev.num_tx_antennas,
            "num_Rx_antennas": dev.num_rx_antennas,
            "carrier_frequency": d.carrier_frequency,
            "num_ADC_samples_per_chirp": dev.nts,
            "num_chirps_per_frame": dev.pn,
            "sampling_frequency": dev.samplerate_hz,
            "range_fft_size": a.range_fft_size,
            "Doppler_fft_size": a.doppler_fft_size,
            "IF_scale": d.if_scale,
            "range_threshold": a.range_threshold,
            "Doppler_threshold": a.doppler_threshold,
            "min_distance": a.min_distance,
            "max_distance": a.max_distance,
            "max_num_targets": a.max_num_targets,
            "lambda": d.wavelength,
            "Hz_to_mps_constant": d.hz_to_mps,
            "R_max": d.r_max,
            "dist_per_bin": d.dist_per_bin,
            "fD_max": d.fd_max,
            "fD_per_bin": d.fd_per_bin,
            "window_length": a.stft_window_length,
            "overlap": a.stft_window_length - (a.stft_hop or 1),
        }
        return json.dumps(obj, indent=2)


def default_device_config() -> DeviceConfig:
    """A representative Infineon 24 GHz config.

    The repo ships no radar_data.xml, so defaults are chosen to reproduce the
    reference's own annotated numbers: NTS=64 and BW=200 MHz give
    R_max = 64*3e8/(2*2e8) = 48 m and dist_per_bin = 48/256 = 0.1875 m,
    matching the comments at radar_processing.m:141-144.
    """
    return DeviceConfig(
        chirp_duration_ns=300_000.0,  # 300 us up-chirp
        lower_frequency_khz=24_025_000.0,
        upper_frequency_khz=24_225_000.0,  # BW = 200 MHz
        num_tx_antennas=1,
        num_rx_antennas=2,
        num_samples_per_chirp=64,
        num_chirps_per_frame=16,
        samplerate_hz=64 / 300e-6,
    )


def next_pow2(n: int) -> int:
    """2^nextpow2(n) (radar_processing.m:273)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()
