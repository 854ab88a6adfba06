"""MATLAB's window functions in float64 NumPy, as the reference uses them
(radar_processing.m:138-139 ``2*blackman(NTS)``, ``2*chebwin(PN)``;
:276 ``kaiser(20, 3)``), written from their definitions."""

from __future__ import annotations

import numpy as np


def blackman(n: int) -> np.ndarray:
    """Symmetric Blackman window (MATLAB ``blackman(n)``)."""
    if n == 1:
        return np.ones(1)
    x = 2.0 * np.pi * np.arange(n) / (n - 1)
    return 0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2.0 * x)


def kaiser(n: int, beta: float) -> np.ndarray:
    """Symmetric Kaiser window (MATLAB ``kaiser(n, beta)``)."""
    if n == 1:
        return np.ones(1)
    a = (n - 1) / 2.0
    r = (np.arange(n) - a) / a
    return np.i0(beta * np.sqrt(np.clip(1.0 - r * r, 0.0, None))) / np.i0(beta)


def chebwin(n: int, at: float = 100.0) -> np.ndarray:
    """Dolph-Chebyshev window (MATLAB ``chebwin(n, at)``), peak 1: the
    Chebyshev polynomial of order n−1 sampled on the unit circle and
    inverse-transformed by a direct cosine sum."""
    if n == 1:
        return np.ones(1)
    order = n - 1
    x0 = np.cosh(np.arccosh(10.0 ** (abs(at) / 20.0)) / order)
    k = np.arange(n)
    x = x0 * np.cos(np.pi * k / n)
    t = np.where(np.abs(x) <= 1.0,
                 np.cos(order * np.arccos(np.clip(x, -1.0, 1.0))),
                 np.cosh(order * np.arccosh(np.maximum(np.abs(x), 1.0)))
                 * np.where((x < -1.0) & (order % 2 == 1), -1.0, 1.0))
    # Samples of the window at m − (n−1)/2 (symmetric about the centre).
    m = np.arange(n) - (n - 1) / 2.0
    phase = np.exp(2j * np.pi * np.outer(m, k) / n)
    w = np.real(phase @ t)
    return w / w.max()
