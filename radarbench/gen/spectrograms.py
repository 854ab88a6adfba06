"""Seeded micro-Doppler spectrogram images, as PNG bytes.

The pictures that the service's ``POST /classify`` takes: a dB map of
Doppler frequency (0 at the bottom, ``freq_limit_hz`` at the top) over
time, clipped to ``clim_db`` and coloured with MATLAB's jet map, as
``radar_processing.m`` exports a spectrogram (``ylim [0 150]``, ``clim
[-40 0]``, ``colormap jet``). Each image shows one target of a class of
``classes``: a body line at ``body_hz`` and ``limbs`` lines swinging
about it, ``depth_hz`` deep at ``rate_hz`` (a gait), on a speckled noise
floor ``snr_db`` under the body; ``gain_db`` shifts the whole map, as a
target nearer or farther would. Every range is [low, high] and drawn
uniformly per image. The map is made at ``bins`` × ``columns`` and
scaled to the image size nearest-neighbour.

Everything is drawn from the seed with NumPy on the host in a few whole
arrays; the classes come in equal numbers, in an order drawn from the
seed. Nothing here imports the program.
"""

from __future__ import annotations

import io

import numpy as np


def jet(values: np.ndarray) -> np.ndarray:
    """MATLAB's jet colour map: values in [0, 1] → uint8 RGB."""
    v = np.clip(values, 0.0, 1.0)[..., None]
    centre = np.array([3.0, 2.0, 1.0])  # r, g, b
    return (np.clip(1.5 - np.abs(4.0 * v - centre), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def dB_maps(n: int, params: dict, rng: np.random.Generator) -> tuple[np.ndarray, list[str]]:
    """[n, bins, columns] dB maps (row 0 the highest frequency) and the
    class of each."""
    names = sorted(params["classes"])
    if n % len(names):
        raise ValueError(f"{n} images do not split over the classes {names}")
    labels = [names[i] for i in rng.permutation(np.arange(n) % len(names))]
    bins, cols = params["bins"], params["columns"]
    freqs = (np.arange(bins)[::-1] + 0.5) * params["freq_limit_hz"] / bins  # top row first
    t = np.arange(cols) * params["column_s"]
    limbs = max(params["classes"][c]["limbs"] for c in names)

    def draw(key, shape=()):
        lo = np.array([params["classes"][c][key][0] for c in labels])
        hi = np.array([params["classes"][c][key][1] for c in labels])
        u = rng.random((n, *shape))
        return (lo + (hi - lo) * u.T).T

    body, rate, depth = draw("body_hz"), draw("rate_hz"), draw("depth_hz")
    phase = rng.uniform(0.0, 2.0 * np.pi, (n, limbs))
    swing = rng.uniform(0.5, 1.0, (n, limbs))  # each limb's share of the depth
    present = np.arange(limbs) < np.array([params["classes"][c]["limbs"] for c in labels])[:, None]
    snr = rng.uniform(*params["snr_db"], n)
    gain = rng.uniform(*params["gain_db"], n)
    speckle = rng.exponential(1.0, (n, bins, cols))

    # Line centres [n, 1 + limbs, cols]: the body, then the limbs about it.
    swing_hz = (depth[:, None] * swing)[..., None] * np.sin(
        2.0 * np.pi * rate[:, None, None] * t + phase[..., None])
    centres = body[:, None, None] + np.concatenate(
        [np.zeros((n, 1, cols)), swing_hz], axis=1)
    amp = np.concatenate([np.ones((n, 1)), np.where(present, 10 ** (-6 / 10), 0.0)], axis=1)
    width = params["line_hz"]
    power = np.zeros((n, bins, cols))
    for k in range(centres.shape[1]):
        d = freqs[None, :, None] - centres[:, k][:, None, :]
        power += amp[:, k, None, None] * np.exp(-0.5 * (d / width) ** 2)
    power += 10 ** (-snr / 10)[:, None, None] * speckle
    return 10.0 * np.log10(power) + gain[:, None, None], labels


def spectrogram_pngs(n: int, size: tuple[int, int], params: dict,
                     seed: int) -> tuple[list[bytes], list[str]]:
    """``n`` PNGs of ``size`` (height, width) and their classes, from
    ``seed``."""
    from PIL import Image

    maps, labels = dB_maps(n, params, np.random.default_rng(seed))
    lo, hi = params["clim_db"]
    h, w = size
    rows = np.arange(h) * maps.shape[1] // h
    cols = np.arange(w) * maps.shape[2] // w
    rgb = jet((np.clip(maps[:, rows][:, :, cols], lo, hi) - lo) / (hi - lo))
    pngs = []
    for img in rgb:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        pngs.append(buf.getvalue())
    return pngs, labels
