"""The plain reference of the spectrogram export, in float64 PyTorch
(radar_processing.m:270-299).

The one-sided PSD spectrogram of |slow-time signal| with kaiser(W, β),
hop 1 and a zero-padded nfft-point FFT per column, scaled by
1/(fs·Σw²) and doubled off the DC and Nyquist bins; dB as
20·log10(P / max P) over the valid columns, −1000 where P = 0 or below;
and a linear re-gridding of the dB map onto ``num_bins`` log-spaced
frequencies between bin 1 and the last bin. Columns are computed in
blocks, so that a recording of any length fits.
"""

from __future__ import annotations

import numpy as np
import torch

from radarbench.reference.windows import kaiser

DB_FLOOR = -1000.0


class StftRef:
    """Hop-1 spectrogram of a real float64 signal on a torch device."""

    def __init__(self, window: int, beta: float, nfft: int, fs: float,
                 num_bins: int, on):
        self.window, self.nfft, self.fs, self.num_bins = window, nfft, fs, num_bins
        w = kaiser(window, beta)
        self.nb = nfft // 2 + 1
        self.w = torch.as_tensor(w, device=on)
        dbl = np.full(self.nb, 2.0)
        dbl[0] = 1.0
        if nfft % 2 == 0:
            dbl[-1] = 1.0
        self.gain = torch.as_tensor(dbl / (fs * np.sum(w * w)), device=on)[:, None]
        pos = np.logspace(0.0, np.log10(self.nb - 1), num_bins)
        i0 = np.clip(np.floor(pos).astype(np.int64), 0, self.nb - 2)
        self.i0 = torch.as_tensor(i0, device=on)
        self.frac = torch.as_tensor(pos - i0, device=on)[:, None]
        self.pos = pos

    def columns(self, length: int) -> int:
        return max(length - self.window + 1, 0)

    def power(self, x: torch.Tensor, start: int, stop: int) -> torch.Tensor:
        """P [nb, stop − start] of the columns starting at samples
        start..stop−1 of x [L] (float64)."""
        seg = x[start:stop + self.window - 1].unfold(0, self.window, 1)
        s = torch.fft.rfft(seg * self.w, n=self.nfft, dim=1)
        return (s.real ** 2 + s.imag ** 2).T * self.gain

    def gmax(self, x: torch.Tensor, block: int) -> torch.Tensor:
        n = self.columns(x.shape[0])
        g = torch.zeros((), dtype=torch.float64, device=x.device)
        for s in range(0, n, block):
            g = torch.maximum(g, self.power(x, s, min(s + block, n)).amax())
        return g

    @staticmethod
    def db(p: torch.Tensor, gmax: torch.Tensor) -> torch.Tensor:
        safe = torch.where(gmax > 0, gmax, torch.ones_like(gmax))
        d = 20.0 * torch.log10(torch.clamp_min(p, 1e-300) / safe)
        return torch.where(p > 0, torch.clamp_min(d, DB_FLOOR), DB_FLOOR)

    def rescale(self, db: torch.Tensor) -> torch.Tensor:
        """[nb, T] → [num_bins, T], linear in the dB values."""
        lo, hi = db[self.i0], db[self.i0 + 1]
        return lo + self.frac * (hi - lo)

    def freqs(self) -> np.ndarray:
        return np.arange(self.nb) * (self.fs / self.nfft)

    def log_freqs(self) -> np.ndarray:
        return (self.fs / self.nfft) * self.pos

    def times(self, n: int) -> np.ndarray:
        return (np.arange(n) + self.window / 2.0) / self.fs
