"""Context-parallel STFT: overlap-save with a one-hop halo exchange.

The reference's STFT is one serial ``spectrogram`` call over the whole
concatenated slow-time signal (radar_processing.m:276). Here the time axis
is sharded over the ``data`` axis: each rank holds a contiguous chunk of
samples and computes the STFT columns that *start* in its chunk. A column
starting in the last W−1 samples of a chunk reads into the next chunk, so
each rank takes those W−1 = 19 boundary samples from its right neighbour
with one :meth:`Mesh.ppermute` — the overlap-save halo, independent of the
signal's length. The dB normalization needs the global PSD max: one
:meth:`Mesh.pmax` over the mesh (radar_processing.m:282-283's max(P(:))
made distributed). The columns are the port's plain operator product
(dsp/stft.py::StftOperator), as the JAX package's ``op(ext)`` is XLA.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fmcw_radar_processing_tpu_torch.dsp.stft import StftOperator, psd_db
from fmcw_radar_processing_tpu_torch.parallel.mesh import DATA_AXIS, Mesh


@dataclasses.dataclass(frozen=True)
class ShardedStft:
    """Sharded wrapper over a StftOperator (hop 1).

    Call on each rank with its chunk [L/n] of the packed slow-time
    magnitude signal and the global valid length; returns this rank's
    (power [nb, L/n], psd_db [nb, L/n], col_valid [L/n]). Local column t
    is the window starting at global sample index·L/n + t; the last W−1
    columns of the signal (and any past valid_len) are masked, the
    fixed-capacity convention of the single-device operator.
    """

    op: StftOperator
    mesh: Mesh
    # --- measurement switches (the scaling bench's sp decomposition) ---
    # Turning any of these off gives WRONG results at shard boundaries or
    # in the dB normalization; they exist to attribute cost stage by stage.
    exchange_halo: bool = True  # False: zeros instead of the neighbour's halo
    global_db_max: bool = True  # False: the shard's max instead of the pmax
    compute_db: bool = True  # False: skip the log (the db slot = power)

    def __call__(self, signal: torch.Tensor, valid_len):
        op, mesh = self.op, self.mesh
        w = op.window_length
        n = mesh.shape[DATA_AXIS]
        x = signal.to(torch.float32)
        chunk = x.shape[0]
        if n > 1 and chunk < w - 1:
            raise ValueError(f"chunk {chunk} shorter than the W-1 = {w - 1} "
                             "sample halo")
        # Halo: the first W−1 samples of the right neighbour. The perm wraps
        # circularly, so the last rank gets rank 0's head, harmless: its
        # trailing columns are the signal's last W−1 starts, masked below.
        # At n = 1 the (identity) exchange still runs and its result is
        # discarded, as in JAX.
        if self.exchange_halo:
            halo = mesh.ppermute(x[: w - 1].contiguous(), DATA_AXIS,
                                 [(i, (i - 1) % n) for i in range(n)]
                                 if n > 1 else [(0, 0)])
        if not (n > 1 and self.exchange_halo):
            halo = torch.zeros(w - 1, dtype=x.dtype, device=x.device)
        ext = torch.cat([x, halo])
        local_p = op(ext).power[:, :chunk]
        # Global column validity: col_global = index·chunk + t must satisfy
        # col_global + W ≤ valid_len.
        col_global = (mesh.index(DATA_AXIS) * chunk
                      + torch.arange(chunk, device=x.device))
        valid = col_global + w <= torch.as_tensor(valid_len, device=x.device)
        local_p = torch.where(valid[None, :], local_p, 0.0)
        g = local_p.amax() if chunk else local_p.new_zeros(())
        if self.global_db_max:
            g = mesh.pmax(g, mesh.axis_names)
        if not self.compute_db:
            # A plain data dependence on g keeps the max (and the pmax) in
            # the measured work; eager PyTorch folds nothing away.
            return local_p, local_p + 0.0 * g, valid
        return local_p, psd_db(local_p, g), valid

    @property
    def freqs(self) -> np.ndarray:
        return (np.arange(self.op.num_bins, dtype=np.float32)
                * np.float32(self.op.fs / self.op.nfft))

    def times(self, total_len: int) -> np.ndarray:
        return ((np.arange(total_len, dtype=np.float32)
                 + np.float32(self.op.window_length / 2.0))
                / np.float32(self.op.fs))
