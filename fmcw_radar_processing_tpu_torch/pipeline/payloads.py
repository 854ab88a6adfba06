"""JSON payload builders — byte-compatible with the reference's four schemas.

Schemas (SURVEY §2.1 "JSON writers"):
  1. spectrogram_data.json           (radar_processing.m:306-328; batch
     variant with start/end frame metadata :576-596)
  2. <name>_range_fft_data.json      (:355-377)
  3. <name>_range_speed_data.json    (:379-407)
  4. <name>_fft_data.json            (:409-436)

Builders are host-side NumPy: they run once per recording on final results.
This is a copy of the JAX package's ``pipeline/payloads.py``, which sits
behind a jax-importing package ``__init__``.
"""

from __future__ import annotations

import numpy as np

from fmcw_radar_processing_tpu.config import RadarConfig


def spectrogram_payload(
    times: np.ndarray,
    log_freq_bins: np.ndarray,
    intensity: np.ndarray,
    *,
    batch: int | None = None,
    start_frame: int | None = None,
    end_frame: int | None = None,
    filename_base: str | None = None,
) -> dict:
    """spectrogram_data schema (:306-312); batch variant (:576-584).

    intensity: (freq_bins, T) dB matrix.
    """
    if batch is None:
        return {
            "time": np.asarray(times),
            "frequency": np.asarray(log_freq_bins),
            "intensity": np.asarray(intensity),
            "title": "All Frames - Log-Scaled Spectrogram",
            "xLabel": "Time (s)",
            "yLabel": "Frequency (Hz)",
        }
    return {
        "time": np.asarray(times),
        "frequency": np.asarray(log_freq_bins),
        "intensity": np.asarray(intensity),
        "title": f"Spectrogram - Batch {batch}",
        "xLabel": "Time (s) (relative to detected activity)",
        "yLabel": "Frequency (Hz)",
        "start_frame": start_frame,
        "end_frame": end_frame,
        "filename_base": filename_base,
    }


def range_fft_payload(
    waterfall: np.ndarray, cfg: RadarConfig, filename: str
) -> dict:
    """<name>_range_fft_data schema (:355-361).

    waterfall: (K, F) — abs-max-over-chirps range profile per frame.
    time axis: 0.15 s per frame (:355 hard-codes 0.15, which equals
    frame_time).
    """
    k, f = waterfall.shape
    return {
        "time_axis": np.arange(f) * cfg.algorithm.frame_time,
        "array_bin_range": np.asarray(cfg.derived.range_axis(k)),
        "range_tx1rx1_max_abs": np.asarray(waterfall),
        "filename": filename,
    }


def transposed_measurements_literal(canonical: np.ndarray) -> np.ndarray:
    """Quirk #1 literal layout (compat_transposed_measurements).

    canonical: (T, F) NaN-filled measurements. The reference 'no' branch
    writes value(frame fr1, target j1) at subscript (fr1, j1) of an array
    preallocated zeros(T, F) (radar_processing.m:157-159, :245-250);
    MATLAB grows rows on demand and growth/prealloc cells stay ZERO. The
    result is a (max(T, last written frame), F) matrix with measurements
    down column j and zeros elsewhere.
    """
    t, f = canonical.shape
    valid = np.argwhere(~np.isnan(canonical))  # rows: (j0, fr0)
    last_fr1 = int(valid[:, 1].max()) + 1 if len(valid) else 0
    out = np.zeros((max(t, last_fr1), f), canonical.dtype)
    for j0, fr0 in valid:
        out[fr0, j0] = canonical[j0, fr0]
    return out


def range_speed_payload(
    target_range: np.ndarray, target_speed: np.ndarray, cfg: RadarConfig,
    filename: str,
) -> dict:
    """<name>_range_speed_data schema (:386-389). NaN → null in JSON.

    With compat_transposed_measurements the arrays take the literal
    MATLAB-grown layout of quirk #1 (see transposed_measurements_literal).
    """
    f = target_range.shape[-1]
    rng, spd = np.asarray(target_range), np.asarray(target_speed)
    if cfg.algorithm.compat_transposed_measurements:
        rng = transposed_measurements_literal(rng)
        spd = transposed_measurements_literal(spd)
    return {
        "time_axis": np.arange(f) * cfg.algorithm.frame_time,
        "range": rng,
        "speed": spd,
        "filename": filename,
    }


def fft_snapshot_payload(
    waterfall: np.ndarray, cfg: RadarConfig, filename: str,
    frame_index: int = 100,
    literal_chirp_magnitude: np.ndarray | None = None,
) -> dict:
    """<name>_fft_data schema (:418-422): single-frame range profile.

    The reference indexes the 3-D FFT cube with 2 subscripts
    (radar_processing.m:411), which via MATLAB linear indexing grabs chirp
    #100 overall instead of frame #100 (SURVEY Appendix A #2). Default is
    the documented *intent*: the chirp-integrated profile of frame
    ``frame_index`` (1-based, clamped to the recording length).

    With compat_linear_index_snapshot the caller passes
    ``literal_chirp_magnitude`` — |range FFT| of literal chirp #100
    overall (frame ⌈100/PN⌉, chirp 100−PN·⌊99/PN⌋) — and the payload keeps
    the reference's ``frame_index: 100`` label (which names a chirp).
    """
    k, f = waterfall.shape
    if cfg.algorithm.compat_linear_index_snapshot:
        if literal_chirp_magnitude is None:
            raise ValueError(
                "compat_linear_index_snapshot needs literal_chirp_magnitude"
            )
        return {
            "range_bins": np.arange(k),
            "magnitude": np.asarray(literal_chirp_magnitude),
            "frame_index": frame_index,  # the reference's literal label
            "filename": filename,
        }
    fr = min(max(frame_index, 1), f)
    return {
        "range_bins": np.arange(k),
        "magnitude": np.asarray(waterfall[:, fr - 1]),
        "frame_index": fr,
        "filename": filename,
    }
