"""The float64 NumPy oracle of the reference MATLAB chain, for the SNR ladder.

A literal, per-frame, loop-based float64 re-statement of
``radar-etl-pipeline/radar_processing.m`` (cited per function): the fast-
and slow-time chain of a recording, the spectrogram, its dB map and the
log-frequency rescale. The port's own copy of what
``tools/snr_ladder.py`` needs from the repository's test oracle
(``tests/oracle.py``), built on the port's ``config`` and
``dsp/windows.py``: NumPy only, no torch and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fmcw_radar_processing_tpu_torch.config import RadarConfig
from fmcw_radar_processing_tpu_torch.config.radar import next_pow2
from fmcw_radar_processing_tpu_torch.dsp.windows import blackman, chebwin, kaiser


def fast_time_oracle(
    chirps: np.ndarray, calib: np.ndarray, cfg: RadarConfig
) -> np.ndarray:
    """radar_processing.m:201-205 for one frame.

    chirps: (NTS, PN) MATLAB layout (samples x chirps), real or complex.
    Returns range FFT (K, PN) complex128.
    """
    pn = cfg.pn
    x = chirps.astype(np.complex128)
    x = (x - calib[:, None]) * cfg.derived.if_scale  # :203
    x = x - x.mean(axis=0, keepdims=True)  # :204  (column-wise mean)
    w = 2.0 * blackman(cfg.nts)
    return np.fft.fft(x * w[:, None], n=cfg.range_fft_size, axis=0)  # :205


def integrate_profile_oracle(range_fft: np.ndarray) -> np.ndarray:
    """abs(max(X, [], 2)) — MATLAB complex max is max-by-magnitude (:210)."""
    return np.abs(range_fft).max(axis=1)


def search_peak_oracle(
    profile: np.ndarray, cfg: RadarConfig
) -> tuple[np.ndarray, np.ndarray]:
    """f_search_peak semantics (defined in dsp/detection.py's docstring):
    local maxima above range_threshold within the distance gate, strongest
    first, up to max_num_targets. Returns (idx0, mag) with 0-based bins.
    """
    a = cfg.algorithm
    d = cfg.derived
    k = len(profile)
    peaks = []
    for i in range(k):
        dist = i * d.dist_per_bin
        if dist < a.min_distance or dist > a.max_distance:
            continue
        left = profile[i - 1] if i > 0 else -np.inf
        right = profile[i + 1] if i < k - 1 else -np.inf
        if profile[i] >= left and profile[i] >= right and profile[i] > a.range_threshold:
            peaks.append((profile[i], i))
    peaks.sort(key=lambda t: (-t[0], t[1]))
    peaks = peaks[: a.max_num_targets]
    return (
        np.array([i for _, i in peaks], np.int64),
        np.array([m for m, _ in peaks], np.float64),
    )


def slow_time_oracle(
    range_fft: np.ndarray, tgt_idx: np.ndarray, cfg: RadarConfig
) -> np.ndarray:
    """radar_processing.m:216-219: Doppler FFT at detected bins only.

    range_fft: (K, PN). Returns range-Doppler map (K, D), zeros at
    non-detected bins (matching the zeros-initialized matrix at :216).
    """
    k = cfg.range_fft_size
    d = cfg.doppler_fft_size
    rd = np.zeros((k, d), np.complex128)
    if len(tgt_idx) == 0:
        return rd
    rows = range_fft[tgt_idx, :].copy()
    rows = rows - rows.mean(axis=1, keepdims=True)  # :217-218
    w = 2.0 * chebwin(cfg.pn)
    rd[tgt_idx, :] = np.fft.fftshift(
        np.fft.fft(rows * w[None, :], n=d, axis=1), axes=1
    )  # :219
    return rd


def doppler_extract_oracle(
    rd_map: np.ndarray, tgt_idx: np.ndarray, cfg: RadarConfig
) -> tuple[np.ndarray, np.ndarray]:
    """radar_processing.m:227-250: per-target Doppler bin + speed (0-based)."""
    a = cfg.algorithm
    d = cfg.derived
    zero_bin = cfg.zero_doppler_bin  # == 8 == 1-based bin 9 for D=16 (:234)
    dop_idx = []
    speeds = []
    for i in tgt_idx:
        row = np.abs(rd_map[i, :])
        j = int(np.argmax(row))
        if row[j] >= a.doppler_threshold and j != zero_bin:
            dj = j
        else:
            dj = zero_bin
        dop_idx.append(dj)
        speeds.append((dj - zero_bin) * -d.fd_per_bin * d.hz_to_mps)  # :250
    return np.array(dop_idx, np.int64), np.array(speeds, np.float64)


@dataclasses.dataclass
class RecordingOracleResult:
    range_fft_complete: np.ndarray  # (K, PN, F) complex — :207
    waterfall: np.ndarray  # (K, F) — squeeze(abs(max(...,[],2))), :265
    strength: np.ndarray  # (T, F), NaN-filled ('yes' convention)
    range: np.ndarray  # (T, F)
    speed: np.ndarray  # (T, F)
    slow_time_signal: np.ndarray  # complex concat of strongest-bin chirps, :255-260
    detected: np.ndarray  # (F,) bool


def process_recording_oracle(
    frames: np.ndarray, calib: np.ndarray, cfg: RadarConfig
) -> RecordingOracleResult:
    """The reference hot loop (radar_processing.m:197-265) on a recording.

    frames: (F, NTS, PN) rx1 chirps in MATLAB per-frame layout.
    """
    f = frames.shape[0]
    k = cfg.range_fft_size
    t = cfg.algorithm.max_num_targets
    complete = np.zeros((k, cfg.pn, f), np.complex128)
    strength = np.full((t, f), np.nan)
    rng = np.full((t, f), np.nan)
    spd = np.full((t, f), np.nan)
    slow = []
    detected = np.zeros(f, bool)
    for fr in range(f):
        rf = fast_time_oracle(frames[fr], calib, cfg)
        complete[:, :, fr] = rf
        profile = integrate_profile_oracle(rf)
        idx, mag = search_peak_oracle(profile, cfg)
        rd = slow_time_oracle(rf, idx, cfg)
        dj, sp = doppler_extract_oracle(rd, idx, cfg)
        for j in range(len(idx)):
            strength[j, fr] = mag[j]
            rng[j, fr] = idx[j] * cfg.derived.dist_per_bin
            spd[j, fr] = sp[j]
        if len(idx) > 0:
            detected[fr] = True
            slow.append(complete[idx[0], :, fr])  # strongest bin, :258-259
    waterfall = np.abs(complete).max(axis=1)
    slow_sig = np.concatenate(slow) if slow else np.zeros(0, np.complex128)
    return RecordingOracleResult(
        range_fft_complete=complete,
        waterfall=waterfall,
        strength=strength,
        range=rng,
        speed=spd,
        slow_time_signal=slow_sig,
        detected=detected,
    )


def spectrogram_oracle(
    iq: np.ndarray, fs: float, window_length: int = 20, beta: float = 3.0,
    hop: int = 1, nfft: int | None = None,
):
    """MATLAB spectrogram semantics (radar_processing.m:270-283) in NumPy.

    iq: real signal. Returns (freqs, times, P) one-sided PSD.
    """
    w = kaiser(window_length, beta)
    if nfft is None:
        nfft = next_pow2(len(iq))
    n_seg = (len(iq) - window_length) // hop + 1
    nb = nfft // 2 + 1
    p = np.zeros((nb, n_seg))
    for s in range(n_seg):
        seg = iq[s * hop : s * hop + window_length] * w
        spec = np.fft.fft(seg, n=nfft)[:nb]
        pp = np.abs(spec) ** 2 / (fs * np.sum(w**2))
        pp[1:] *= 2.0
        if nfft % 2 == 0:
            pp[-1] /= 2.0
        p[:, s] = pp
    freqs = np.arange(nb) * fs / nfft
    times = (np.arange(n_seg) * hop + window_length / 2.0) / fs
    return freqs, times, p


def psd_db_oracle(p: np.ndarray) -> np.ndarray:
    """20·log10(P/max) — note 20, not 10, of a power quantity (:282-283)."""
    g = p.max()
    with np.errstate(divide="ignore"):
        return 20.0 * np.log10(p / g) if g > 0 else np.full_like(p, -np.inf)


def log_rescale_oracle(freqs: np.ndarray, psd: np.ndarray, num_bins: int = 1024):
    """radar_processing.m:291-299 (with the fftshift no-op folded out)."""
    min_f = freqs[freqs > 0].min()
    max_f = freqs.max()
    log_bins = np.logspace(np.log10(min_f), np.log10(max_f), num_bins)
    out = np.empty((num_bins, psd.shape[1]))
    for c in range(psd.shape[1]):
        out[:, c] = np.interp(log_bins, freqs, psd[:, c])
    return log_bins, out
