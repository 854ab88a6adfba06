"""Complex-as-pair arithmetic: complex values as a trailing length-2 axis.

The device path holds no complex dtypes, as in the JAX package: every
complex quantity is a float32 tensor with a trailing [re, im] axis. The
host converts NumPy complex arrays at the I/O boundary with
:func:`to_pair`.

Precision: a float32 matmul on an H100 may run in TF32 (about three
decimal digits) when ``torch.backends.cuda.matmul.allow_tf32`` or
``torch.backends.cudnn.allow_tf32`` is on — the GPU form of the TPU's
DEFAULT-precision trap. :func:`pin_f32_matmul` turns both off and checks
it; every contraction here runs at true float32. On the CPU it also
settles MKL's vector math (:func:`settle_cpu_math`), whose first threaded
call in a process could lose precision.

:func:`resolve_device` is how the entry points take their device: the
card by default, an error rather than the CPU when there is none.
"""

from __future__ import annotations

import numpy as np
import torch


_VML_SETTLED = False


def settle_cpu_math() -> None:
    """Make this process's first call of MKL's vector math library (VML)
    a single-threaded one, once.

    PyTorch's CPU ``sqrt``, ``exp``, ``log10`` and their kin go through
    VML on float32. On an Intel Xeon with AVX-512 (torch 2.13, MKL
    2024.2), the first VML call of a process that ran on two threads after
    a threaded MKL GEMM now and then (one process in 20 to 40) returned
    the calling thread's share at about 12-bit accuracy: ``sqrt`` 3.2e-4
    and ``exp`` 1.5e-4 relative, the same values each time, the other
    thread's share exact (``tools/vml_first_call_probe.py`` reproduces
    it). One call on one element first prevented it in every run.
    """
    global _VML_SETTLED
    if not _VML_SETTLED:
        torch.sqrt(torch.ones(1))
        _VML_SETTLED = True


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a torch.device; raises RuntimeError for a CUDA device
    when no card is available (the entry points default to "cuda" and
    never fall back to the CPU). A CPU device settles VML first
    (:func:`settle_cpu_math`)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           "torch.cuda.is_available() is False")
    if dev.type == "cpu":
        settle_cpu_math()
    return dev


def pin_f32_matmul() -> None:
    """Turn TF32 off for matmuls and convolutions, and check that it is
    off; settle the CPU's vector math first (:func:`settle_cpu_math`)."""
    settle_cpu_math()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("TF32 could not be turned off")


def to_pair(x: np.ndarray) -> np.ndarray:
    """complex (or real) NumPy array → [..., 2] float32 pair."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return np.stack([x.real, x.imag], axis=-1).astype(np.float32)
    return np.stack([x, np.zeros_like(x)], axis=-1).astype(np.float32)


def pair_abs(x: torch.Tensor) -> torch.Tensor:
    """|z| of a pair tensor: [..., 2] → [...]."""
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1])


def pair_matmul(x: torch.Tensor, m_re: torch.Tensor, m_im: torch.Tensor,
                spec: str) -> torch.Tensor:
    """Complex contraction of a pair tensor with a constant complex matrix.

    x: [..., 2] pair operand; m_re/m_im: real/imag parts of the matrix;
    spec: einsum spec for ONE real contraction (e.g. '...tp,dp->...td').
    Four real float32 einsums with TF32 off.
    """
    pin_f32_matmul()
    xr, xi = x[..., 0], x[..., 1]
    yr = torch.einsum(spec, xr, m_re) - torch.einsum(spec, xi, m_im)
    yi = torch.einsum(spec, xr, m_im) + torch.einsum(spec, xi, m_re)
    return torch.stack([yr, yi], dim=-1)
