"""Complex-as-pair arithmetic: complex values as a trailing length-2 axis.

The device path holds no complex dtypes, as in the JAX package: every
complex quantity is a float32 tensor with a trailing [re, im] axis. The
host converts NumPy complex arrays at the I/O boundary with
:func:`to_pair`.

Precision: a float32 matmul on an H100 may run in TF32 (about three
decimal digits) when ``torch.backends.cuda.matmul.allow_tf32`` or
``torch.backends.cudnn.allow_tf32`` is on — the GPU form of the TPU's
DEFAULT-precision trap. :func:`pin_f32_matmul` turns both off and checks
it. On the CPU it also settles MKL's vector math
(:func:`settle_cpu_math`), whose first threaded call in a process could
lose precision.

``AlgorithmConfig.matmul_precision`` and ``rescale_precision`` name the
TPU's pass count for a float32 product: "default" is one bf16 pass,
"high" three, "highest" six (:func:`mxu_passes`). :func:`precision_matmul`
computes a product with those semantics on the card: "default" rounds
both operands to bf16 and sums their exact products in float32, "high"
adds hi·hi + lo·hi + hi·lo of the bf16 splits, "highest" is exact float32.
On the CPU every product is exact float32, as XLA:CPU computes it
whatever the precision says (:func:`takes_mxu_passes` decides).

:func:`resolve_device` is how the entry points take their device: the
card by default, an error rather than the CPU when there is none.
"""

from __future__ import annotations

import functools

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


MXU_PASSES = {"default": 1, "high": 3, "highest": 6}


def mxu_passes(name: str) -> int:
    """The TPU's bf16 pass count of a float32 product at precision
    ``name``: 1, 3 or 6; ValueError for any other name (the JAX package's
    ``mxu_precision``)."""
    try:
        return MXU_PASSES[name]
    except KeyError:
        raise ValueError(
            f"unknown matmul precision {name!r} "
            f"(expected default|high|highest)"
        ) from None


def takes_mxu_passes(t: torch.Tensor) -> bool:
    """Whether a product of ``t`` takes the TPU's pass semantics: on a CUDA
    tensor. On the CPU it is exact float32, as on XLA:CPU. The one place
    that decides; a test forces the semantics on the CPU by replacing it."""
    return t.device.type == "cuda"


def split_bf16x3(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(w_hi, w_lo) bf16 on w's device: w_hi = bf16(w), w_lo = bf16(w −
    w_hi), both round to nearest even — the TPU's three-pass split."""
    w_hi = w.to(torch.bfloat16)
    return w_hi, (w - w_hi.to(torch.float32)).to(torch.bfloat16)


def bf16x3_product(a_hi: torch.Tensor, a_lo: torch.Tensor, b_hi: torch.Tensor,
                   b_lo: torch.Tensor, mm=torch.matmul) -> torch.Tensor:
    """hi·hi + lo·hi + hi·lo of float32-widened bf16 terms, summed in that
    order: the three passes of Precision.HIGH (the lo·lo term dropped), each
    product of two bf16 values exact in float32."""
    return mm(a_hi, b_hi) + mm(a_lo, b_hi) + mm(a_hi, b_lo)


def mxu_terms(t: torch.Tensor, precision: str) -> tuple[torch.Tensor, ...]:
    """The float32 terms that ``precision``'s passes multiply: (t,) at
    "highest", (bf16(t),) at "default", (bf16(t), bf16(t − bf16(t))) at
    "high", the bf16 values widened to float32. A strided view is
    materialized once before it is split."""
    passes = mxu_passes(precision)
    if passes == 6:
        return (t,)
    t = t.to(torch.float32).contiguous()
    if passes == 1:
        return (t.to(torch.bfloat16).to(torch.float32),)
    return tuple(h.to(torch.float32) for h in split_bf16x3(t))


def precision_matmul(a: torch.Tensor, b: torch.Tensor,
                     precision: str = "highest", spec: str | None = None,
                     a_terms: tuple | None = None,
                     b_terms: tuple | None = None) -> torch.Tensor:
    """One float32 product a·b (``torch.matmul``, or ``torch.einsum(spec,
    a, b)``) at ``precision``, with TF32 off.

    Where :func:`takes_mxu_passes` holds, "default" multiplies the
    bf16-rounded operands and sums in float32, and "high" is
    :func:`bf16x3_product` of their splits; ``a_terms``/``b_terms`` are an
    operand's :func:`mxu_terms` made beforehand (a constant split once).
    "highest", and every precision elsewhere, is ``torch.matmul(a, b)``
    itself. A bf16 ``torch.matmul`` would round the result to bf16 too.
    """
    passes = mxu_passes(precision)
    pin_f32_matmul()
    mm = torch.matmul if spec is None else functools.partial(torch.einsum, spec)
    if passes == 6 or not takes_mxu_passes(a):
        return mm(a, b)
    a_terms = a_terms or mxu_terms(a, precision)
    b_terms = b_terms or mxu_terms(b, precision)
    if passes == 1:
        return mm(a_terms[0], b_terms[0])
    return bf16x3_product(*a_terms, *b_terms, mm=mm)


def to_pair(x: np.ndarray) -> np.ndarray:
    """complex (or real) NumPy array → [..., 2] float32 pair."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return np.stack([x.real, x.imag], axis=-1).astype(np.float32)
    return np.stack([x, np.zeros_like(x)], axis=-1).astype(np.float32)


def from_pair(x) -> np.ndarray:
    """[..., 2] pair (tensor or array) → NumPy complex, on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    return a[..., 0] + 1j * a[..., 1]


def pair_abs(x: torch.Tensor) -> torch.Tensor:
    """|z| of a pair tensor: [..., 2] → [...]."""
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1])


def pair_matmul(x: torch.Tensor, m_re: torch.Tensor, m_im: torch.Tensor,
                spec: str, precision: str = "highest") -> torch.Tensor:
    """Complex contraction of a pair tensor with a constant complex matrix.

    x: [..., 2] pair operand; m_re/m_im: real/imag parts of the matrix;
    spec: einsum spec for ONE real contraction (e.g. '...tp,dp->...td').
    Four real einsums at ``precision`` (:func:`precision_matmul`).
    """
    def mm(a, m):
        return precision_matmul(a, m, precision, spec)

    xr, xi = x[..., 0], x[..., 1]
    yr = mm(xr, m_re) - mm(xi, m_im)
    yi = mm(xr, m_im) + mm(xi, m_re)
    return torch.stack([yr, yi], dim=-1)
