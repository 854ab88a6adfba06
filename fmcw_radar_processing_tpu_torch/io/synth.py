"""Synthetic IQ recording generator.

The reference repo ships no raw.bin; its processing chain is the only
specification of the data. This generator produces physically-parameterized
recordings whose ground truth is known in *chain* units — a target
requested at range R and reported-speed v lands, by construction, in range
bin round(R / dist_per_bin) and fftshifted Doppler bin zero_bin + d_rel —
so end-to-end tests and benchmarks can assert exact detections.

Signal model, per frame f, chirp p, sample n (rx antenna r):

    x = Σ_t A_t · exp(i·(2π·b_t·n/K + ψ_t(f, p))) + DC + σ·noise + calib[n]

with ψ the slow-time phase: a linear ramp of 2π·d_t/D per chirp
(continuing across frames via PRT) plus an optional micro-Doppler sinusoid
(limb-motion analog) that modulates the phase at ``md_rate_hz`` with
amplitude ``md_phase_rad`` — the feature the DCNN classifier consumes
(SURVEY §0; Main_FYP_DCNN_training.ipynb).

The calibration curve is added to every chirp so that the chain's
calibration subtraction (radar_processing.m:203) removes it exactly.

Speed-axis convention note: the reference maps Doppler bin offsets to m/s
via fD_per_bin = fD_max / D (radar_processing.m:153-154) — half the true
per-bin frequency step of a D-point FFT at PRT sampling. We parametrize
targets by *Doppler bin offset* (or reference-reported speed via
``speed_to_bin_offset``) so ground truth follows the chain's own mapping.

The port's own copy of the JAX package's ``io/synth.py``: one seed gives
the same recording, array for array, in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fmcw_radar_processing_tpu_torch.config import RadarConfig
from fmcw_radar_processing_tpu_torch.io.raw_format import RawRecording


@dataclasses.dataclass(frozen=True)
class SyntheticTarget:
    range_m: float
    doppler_bin_offset: int = 0  # relative to the zero-velocity bin (signed)
    amplitude: float = 4.0
    md_phase_rad: float = 0.0  # micro-Doppler phase-modulation depth
    md_rate_hz: float = 0.0  # micro-Doppler modulation rate

    def range_bin(self, cfg: RadarConfig) -> int:
        return int(round(self.range_m / cfg.derived.dist_per_bin))

    def reported_speed(self, cfg: RadarConfig) -> float:
        """Speed the chain will report for this target
        (radar_processing.m:250)."""
        return (
            self.doppler_bin_offset
            * -cfg.derived.fd_per_bin
            * cfg.derived.hz_to_mps
        )


def speed_to_bin_offset(speed_mps: float, cfg: RadarConfig) -> int:
    """Invert the reference's speed mapping to the nearest Doppler bin."""
    step = -cfg.derived.fd_per_bin * cfg.derived.hz_to_mps
    return int(round(speed_mps / step))


def synthesize_recording(
    cfg: RadarConfig,
    num_frames: int,
    targets: tuple[SyntheticTarget, ...] = (),
    *,
    noise_sigma: float = 0.01,
    dc_offset: complex = 0.2 + 0.1j,
    n_cal_factor: int = 2,
    seed: int = 0,
    target_present: np.ndarray | None = None,
) -> RawRecording:
    """Generate a recording in the raw container format.

    target_present: optional [F] bool mask — frames where targets are
    muted (for detection-gap / activity-mode scenarios).
    """
    rng = np.random.default_rng(seed)
    dev = cfg.device
    nts, pn, k, d = cfg.nts, cfg.pn, cfg.range_fft_size, cfg.doppler_fft_size
    r = dev.num_rx_antennas
    f = num_frames
    prt = cfg.derived.prt

    n = np.arange(nts)
    # Smooth near-DC calibration curve (real device ADC characteristic).
    n_cal = nts * n_cal_factor
    ncal_ax = np.arange(n_cal)
    cal_i = 0.3 + 0.05 * np.cos(2 * np.pi * ncal_ax / n_cal)
    cal_q = 0.15 + 0.03 * np.sin(2 * np.pi * ncal_ax / n_cal)
    calib = np.stack(
        [np.stack([cal_i, cal_q]) for _ in range(r)]
    ).astype(np.float32)  # [R, 2, N_cal]
    dec = n_cal // nts
    calib_c = (cal_i[::dec] + 1j * cal_q[::dec]).astype(np.complex64)

    present = (
        np.ones(f, bool) if target_present is None else np.asarray(target_present)
    )

    # Slow-time (chirp) absolute times: [F, PN]
    tt = (np.arange(f)[:, None] * pn + np.arange(pn)[None, :]) * prt
    x = np.zeros((f, pn, nts), np.complex64)
    for tgt in targets:
        b = tgt.range_bin(cfg)
        d_unshifted = (cfg.zero_doppler_bin + tgt.doppler_bin_offset + d // 2) % d
        fast_phase = 2 * np.pi * b * n / k  # [NTS]
        slow_phase = 2 * np.pi * d_unshifted * np.arange(pn) / d  # [PN] per frame
        md = (
            tgt.md_phase_rad * np.sin(2 * np.pi * tgt.md_rate_hz * tt)
            if tgt.md_phase_rad
            else 0.0
        )  # [F, PN]
        phase = (
            fast_phase[None, None, :]
            + slow_phase[None, :, None]
            + (md[..., None] if np.ndim(md) else 0.0)
        )
        contrib = tgt.amplitude * np.exp(1j * phase)
        x = x + np.where(present[:, None, None], contrib, 0.0).astype(np.complex64)

    x = x + dc_offset
    x = x + noise_sigma * (
        rng.standard_normal((f, pn, nts)) + 1j * rng.standard_normal((f, pn, nts))
    ).astype(np.complex64)
    x = x + calib_c[None, None, :]

    frames = np.broadcast_to(x[:, None], (f, r, pn, nts)).astype(np.complex64)
    return RawRecording(frames=frames.copy(), calib=calib, device=dev)
