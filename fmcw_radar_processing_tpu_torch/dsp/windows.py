"""Window functions: blackman, Dolph-Chebyshev, kaiser (NumPy, host side).

The reference uses MATLAB's windows (radar_processing.m:138-139:
``2*blackman(NTS)``, ``2*chebwin(PN)``; :276: ``kaiser(20, 3)``). They are
configuration-time constants, computed once on the host in float64 and
folded into the operator matrices. These are copies of the JAX package's
``dsp/windows.py`` (which sits behind a jax-importing ``__init__``); the
tests hold them bit-equal to it.
"""

from __future__ import annotations

import numpy as np


def blackman(n: int) -> np.ndarray:
    """Symmetric Blackman window, MATLAB ``blackman(n)`` semantics.

    w[k] = 0.42 - 0.5 cos(2πk/(n-1)) + 0.08 cos(4πk/(n-1)), k = 0..n-1.
    """
    if n == 1:
        return np.ones(1)
    k = np.arange(n, dtype=np.float64)
    x = 2.0 * np.pi * k / (n - 1)
    return 0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2 * x)


def kaiser(n: int, beta: float) -> np.ndarray:
    """Symmetric Kaiser window, MATLAB ``kaiser(n, beta)`` semantics.

    w[k] = I0(β √(1 − (2k/(n−1) − 1)²)) / I0(β).
    """
    if n == 1:
        return np.ones(1)
    k = np.arange(n, dtype=np.float64)
    alpha = (n - 1) / 2.0
    arg = beta * np.sqrt(np.clip(1.0 - ((k - alpha) / alpha) ** 2, 0.0, None))
    return np.i0(arg) / np.i0(beta)


def _cheb_poly(order: float, x: np.ndarray) -> np.ndarray:
    """Chebyshev polynomial T_order(x) extended beyond [-1, 1] via cosh."""
    out = np.zeros_like(x)
    inside = np.abs(x) <= 1.0
    above = x > 1.0
    below = x < -1.0
    out[inside] = np.cos(order * np.arccos(np.clip(x[inside], -1.0, 1.0)))
    out[above] = np.cosh(order * np.arccosh(x[above]))
    # (-1)^order factor for x < -1; order is integer-valued here
    sign = -1.0 if int(round(order)) % 2 else 1.0
    out[below] = sign * np.cosh(order * np.arccosh(-x[below]))
    return out


def chebwin(n: int, attenuation_db: float = 100.0) -> np.ndarray:
    """Dolph-Chebyshev window, MATLAB ``chebwin(n, r)`` semantics (default
    r = 100 dB sidelobe attenuation), normalized to peak 1.

    Constructed in the frequency domain: sample the Chebyshev polynomial of
    order n−1 at x0·cos(πk/n), inverse-transform, fold symmetric.
    """
    if n == 1:
        return np.ones(1)
    order = n - 1.0
    big_r = 10.0 ** (abs(attenuation_db) / 20.0)
    x0 = np.cosh(np.arccosh(big_r) / order)
    k = np.arange(n, dtype=np.float64)
    x = x0 * np.cos(np.pi * k / n)
    p = _cheb_poly(order, x)
    if n % 2:
        w = np.real(np.fft.fft(p))
        m = (n + 1) // 2
        w = w[:m]
        w = np.concatenate((w[m - 1 : 0 : -1], w))
    else:
        p = p * np.exp(1j * np.pi / n * k)
        w = np.real(np.fft.fft(p))
        m = n // 2 + 1
        w = np.concatenate((w[m - 1 : 0 : -1], w[1:m]))
    return w / np.max(w)
