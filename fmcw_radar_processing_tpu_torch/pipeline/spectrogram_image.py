"""Spectrogram PNG rendering — the micro-Doppler classifier's input images.

Replicates the reference's figure export (radar_processing.m:331-348):
top-view surface of the dB PSD, y-limit [0, 150] Hz, color limits
[−40, 0] dB, jet colormap, no axes/colorbar, written as PNG.

Implemented directly with PIL + a NumPy jet colormap (no figure machinery):
the PSD matrix is gridded onto the pixel raster, clipped to the clim, and
color-mapped — deterministic, headless, and orders of magnitude faster than
rasterizing a surf plot. Output defaults to 1200×800 px, the reference's
600 dpi export of a 600×400 pt figure. This is a copy of the JAX package's
``pipeline/spectrogram_image.py``, which sits behind a jax-importing package
``__init__``.
"""

from __future__ import annotations

import numpy as np


def jet_colormap(values: np.ndarray) -> np.ndarray:
    """MATLAB jet colormap: values in [0, 1] → uint8 RGB."""
    v = np.clip(values, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * v - 3.0), 0.0, 1.0)
    g = np.clip(1.5 - np.abs(4.0 * v - 2.0), 0.0, 1.0)
    b = np.clip(1.5 - np.abs(4.0 * v - 1.0), 0.0, 1.0)
    return (np.stack([r, g, b], axis=-1) * 255.0 + 0.5).astype(np.uint8)


def render_spectrogram_png(
    path: str,
    times: np.ndarray,
    freqs: np.ndarray,
    psd_db: np.ndarray,
    *,
    freq_limit: float = 150.0,  # ylim [0 150], radar_processing.m:336
    clim: tuple[float, float] = (-40.0, 0.0),  # :337
    size: tuple[int, int] = (1200, 800),  # 600 dpi export of 600x400 figure, :332,344
) -> str:
    """Render a (freq × time) dB PSD matrix to a PNG file.

    psd_db: (F_bins, T) with rows ordered by ``freqs`` ascending. Frequency
    increases upward in the image (surf orientation with view(0, 90)).
    """
    from PIL import Image

    if psd_db.size == 0:
        img = np.zeros((size[1], size[0], 3), np.uint8)
        Image.fromarray(img).save(path)
        return path

    freqs = np.asarray(freqs, np.float64)
    psd = np.asarray(psd_db, np.float64)
    keep = freqs <= freq_limit
    if keep.any():
        freqs = freqs[keep]
        psd = psd[keep, :]

    w, h = size
    # Nearest-neighbor grid of the (freq, time) matrix onto the pixel raster
    # (matches a dense surf render with EdgeColor none).
    ti = np.minimum(
        (np.arange(w) * psd.shape[1] // w), psd.shape[1] - 1
    )
    # Map pixel rows to frequency values (linear in frequency, top = max).
    f_lo, f_hi = float(freqs.min()), float(max(freqs.max(), freq_limit))
    row_freq = f_hi - (np.arange(h) + 0.5) * (f_hi - f_lo) / h
    fi = np.searchsorted(freqs, row_freq).clip(0, len(freqs) - 1)
    grid = psd[np.ix_(fi, ti)]
    lo, hi = clim
    norm = (np.clip(grid, lo, hi) - lo) / (hi - lo)
    norm = np.where(np.isfinite(grid), norm, 0.0)
    Image.fromarray(jet_colormap(norm)).save(path)
    return path
