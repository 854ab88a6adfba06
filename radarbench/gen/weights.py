"""Seeded random weights of a VGG classifier, made on the device.

The Flax-layout tree of the port's classifier artifact, flat: one array a
``backbone/block{b}_conv{c}/{kernel,bias}`` and ``head/{fc,out}/{kernel,
bias}`` path, convolution kernels [3, 3, Cin, Cout] and Dense kernels
[in, out], float32. Kernels follow Flax's default, lecun_normal: a
normal truncated at ±2σ with σ = √(1/fan_in)/0.8796, so activations stay
in range through the 13 convolutions. Biases are normal with
``bias_std``, so that a program that drops them is seen. Two draws on
the device make every leaf; nothing here imports the program.

The last Dense is then fitted to the pool of images (``fit_readout``), as
training fits a classifier's readout: a random one reads mostly what
every image's features share, so the pool's logits lie within about 1%
of each other's scale and a bf16 forward's rounding moves them by a
fifth of that; the fitted one reads the direction along which the
pool's features differ most, so each image's logit is its own.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TRUNC_STD = 0.87962566103423978  # the std of a unit normal truncated at ±2


def vgg_shapes(blocks, input_shape, head: int) -> dict[str, tuple[tuple, int]]:
    """{leaf path: (shape, fan_in)} of a VGG backbone of ``blocks`` and the
    head Flatten → Dense(``head``) → Dense(1), for ``input_shape`` images."""
    h, w, cin = input_shape
    out: dict[str, tuple[tuple, int]] = {}
    for b, (convs, ch) in enumerate(blocks):
        for c in range(convs):
            name = f"backbone/block{b + 1}_conv{c + 1}"
            out[f"{name}/kernel"] = ((3, 3, cin, ch), 9 * cin)
            out[f"{name}/bias"] = ((ch,), 9 * cin)
            cin = ch
        h, w = h // 2, w // 2
    feats = h * w * cin
    for name, fan_in, width in (("head/fc", feats, head), ("head/out", head, 1)):
        out[f"{name}/kernel"] = ((fan_in, width), fan_in)
        out[f"{name}/bias"] = ((width,), fan_in)
    return out


def vgg_params(blocks, input_shape, head: int, bias_std: float, gen: torch.Generator,
               device) -> dict[str, np.ndarray]:
    """The flat tree of float32 NumPy leaves, drawn on ``device`` from
    ``gen``: one truncated normal for every kernel, one normal for every
    bias."""
    shapes = vgg_shapes(blocks, input_shape, head)
    kernels = [k for k in shapes if k.endswith("/kernel")]
    biases = [k for k in shapes if k.endswith("/bias")]
    sizes = {k: math.prod(shapes[k][0]) for k in shapes}
    # Inverse CDF of the unit normal truncated at ±2.
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(sum(sizes[k] for k in kernels), generator=gen, device=device,
                   dtype=torch.float64)
    z = (math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)).float()
    bias = torch.randn(sum(sizes[k] for k in biases), generator=gen, device=device)
    flat_k, flat_b = z.cpu().numpy(), (bias_std * bias).cpu().numpy()
    out: dict[str, np.ndarray] = {}
    for names, flat in ((kernels, flat_k), (biases, flat_b)):
        at = 0
        for k in names:
            shape, fan_in = shapes[k]
            leaf = flat[at:at + sizes[k]].reshape(shape)
            if k.endswith("/kernel"):
                leaf = leaf * np.float32(math.sqrt(1.0 / fan_in) / TRUNC_STD)
            out[k] = np.ascontiguousarray(leaf, np.float32)
            at += sizes[k]
    return out



def fit_readout(features: np.ndarray, logit_std: float) -> tuple[np.ndarray, np.ndarray]:
    """(kernel [head, 1], bias [1]), float32, of the last Dense fitted to
    ``features`` ([N, head], the first Dense's output of the pool): the
    first principal direction of the centred features (its sign fixed by
    its largest component), scaled so that the pool's logits have the
    standard deviation ``logit_std``, and the bias that centres them on
    0, so that the two classes come about equally often."""
    f = np.asarray(features, np.float64)
    mean = f.mean(0)
    centred = f - mean
    w = np.linalg.svd(centred, full_matrices=False)[2][0]
    w = w * np.sign(w[np.argmax(np.abs(w))])
    w = w * (logit_std / float((centred @ w).std()))
    return w.astype(np.float32)[:, None], np.array([-(mean @ w)], np.float32)
