"""Spectrogram classifiers as ``torch.nn`` modules (the JAX package's
``models/vgg.py``).

The reference trains a VGG16 transfer-learning binary classifier on
micro-Doppler spectrogram PNGs (Main_FYP_DCNN_training.ipynb cell 19:
VGG16 backbone, head = Flatten → Dense(256, relu) → Dropout(0.5) →
Dense(1); logits out, the sigmoid lives in the loss or the inference).

As in the Flax models:
  * inputs are NHWC floats in [0, 1]; the modules permute to NCHW inside;
  * parameters are float32 and compute runs in ``dtype`` (bfloat16 by
    default): inputs, kernels and biases are cast to ``dtype``, and the
    last Dense runs in float32;
  * the head flattens the features in (H, W, C) order, Flax's NHWC order,
    so Flax weights carry over unchanged (models/params.py).
  * layer names follow Flax's (``backbone.block{b}_conv{c}``,
    ``head.fc``/``head.out``; ``Conv_0``.. and ``Dense_0``.. in SmallCNN);
  * ``forward(x, train=True, generator=g)`` applies dropout with Flax's
    semantics, its mask drawn from ``g``; the default is the inference
    forward.

The convolutions and dense layers are plain large products that the JAX
package leaves to XLA; here they are ``torch.nn.functional`` calls.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fmcw_radar_processing_tpu_torch.models.data import BatchShard, rand_rows
from fmcw_radar_processing_tpu_torch.utils.cplx import resolve_device

# Standard VGG16 configuration: (convs per block, channels).
VGG16_BLOCKS: tuple[tuple[int, int], ...] = (
    (2, 64), (2, 128), (3, 256), (3, 512), (3, 512),
)


def _conv_relu(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """3×3 'SAME' convolution in ``dtype``, then ReLU."""
    return F.relu(F.conv2d(x.to(dtype), conv.weight.to(dtype),
                           conv.bias.to(dtype), padding=1))


def _dense(x: torch.Tensor, layer: nn.Linear, dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _dropout(x: torch.Tensor, rate: float, train: bool,
             generator: torch.Generator | BatchShard | None) -> torch.Tensor:
    """Flax's ``nn.Dropout``: in training keep each value with probability
    1 − rate, drawn from ``generator`` (a BatchShard: this rank's rows of
    the global batch's mask), and scale it by 1/(1 − rate); otherwise (or
    at rate 0) the identity."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = rand_rows(generator, x.shape, x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class VGGBackbone(nn.Module):
    """Blocks of 3×3 convolutions (padding 1) + ReLU, each block ending in a
    2×2 / 2 max-pool. NCHW in, NCHW out."""

    def __init__(self, blocks: Sequence[tuple[int, int]] = VGG16_BLOCKS,
                 in_channels: int = 3, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.blocks = tuple(tuple(b) for b in blocks)
        self.dtype = dtype
        cin = in_channels
        for b, (n_convs, ch) in enumerate(self.blocks):
            for c in range(n_convs):
                self.add_module(f"block{b + 1}_conv{c + 1}",
                                nn.Conv2d(cin, ch, 3, padding=1, device=device))
                cin = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for b, (n_convs, _) in enumerate(self.blocks):
            for c in range(n_convs):
                x = _conv_relu(x, getattr(self, f"block{b + 1}_conv{c + 1}"),
                               self.dtype)
            x = F.max_pool2d(x, 2, 2)
        return x


class BinaryHead(nn.Module):
    """Flatten (H, W, C order) → Dense(256, relu) → Dropout(0.5) → Dense(1)
    in float32 (notebook cell 19). NCHW features in, logits [N] out. The
    dropout rate is ``dropout`` (an attribute: 0 turns it off)."""

    def __init__(self, in_features: int, hidden: int = 256,
                 dropout: float = 0.5, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.fc = nn.Linear(in_features, hidden, device=device)
        self.dropout = dropout
        self.out = nn.Linear(hidden, 1, device=device)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x.permute(0, 2, 3, 1).flatten(1)  # Flax's NHWC flatten order
        x = _dropout(F.relu(_dense(x, self.fc, self.dtype)), self.dropout,
                     train, generator)
        return _dense(x, self.out, torch.float32)[..., 0]


class VGG16(nn.Module):
    """VGG16 + binary head. Input NHWC float in [0, 1] of ``input_shape``
    (224×224×3 by default, which fixes the head's width)."""

    def __init__(self, blocks: Sequence[tuple[int, int]] = VGG16_BLOCKS,
                 dtype: torch.dtype = torch.bfloat16,
                 input_shape: tuple[int, int, int] = (224, 224, 3),
                 device=None):
        super().__init__()
        h, w, cin = input_shape
        self.dtype = dtype
        self.backbone = VGGBackbone(blocks, cin, dtype, device)
        n = len(self.backbone.blocks)
        feats = (h >> n) * (w >> n) * self.backbone.blocks[-1][1]
        self.head = BinaryHead(feats, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits [N]; ``train`` turns the head's dropout on, its mask drawn
        from ``generator``."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        return self.head(self.backbone(x), train, generator)


class SmallCNN(nn.Module):
    """Compact spectrogram classifier (same API as VGG16): four conv +
    max-pool blocks (32, 64, 128, 128 channels), a global mean, Dense(128,
    relu), Dropout(0.5) (the ``dropout`` attribute), Dense(1) in float32."""

    CHANNELS = (32, 64, 128, 128)

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 input_shape: tuple[int, int, int] = (224, 224, 3),
                 device=None):
        super().__init__()
        self.dtype = dtype
        cin = input_shape[2]
        for i, ch in enumerate(self.CHANNELS):
            self.add_module(f"Conv_{i}",
                            nn.Conv2d(cin, ch, 3, padding=1, device=device))
            cin = ch
        self.Dense_0 = nn.Linear(cin, 128, device=device)
        self.dropout = 0.5
        self.Dense_1 = nn.Linear(128, 1, device=device)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for i in range(len(self.CHANNELS)):
            x = F.max_pool2d(_conv_relu(x, getattr(self, f"Conv_{i}"),
                                        self.dtype), 2, 2)
        x = x.mean(dim=(2, 3))
        x = _dropout(F.relu(_dense(x, self.Dense_0, self.dtype)), self.dropout,
                     train, generator)
        return _dense(x, self.Dense_1, torch.float32)[..., 0]


MODELS = {"vgg16": VGG16, "small": SmallCNN}


def build_model(name: str, input_shape: tuple[int, int, int],
                device: torch.device | str = "cuda", **kwargs) -> nn.Module:
    """The model ``name`` ("vgg16" or "small") for ``input_shape`` images,
    in eval mode, on ``device`` (the card unless the caller
    asks for "cpu"; "cuda" without a card raises RuntimeError)."""
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; one of {sorted(MODELS)}")
    return MODELS[name](input_shape=tuple(input_shape),
                        device=resolve_device(device), **kwargs).eval()


@torch.no_grad()
def init_flax_default_(model: nn.Module,
                       generator: torch.Generator | None = None) -> nn.Module:
    """Flax's default initializers, in place: kernels lecun_normal (a
    normal truncated at ±2σ, σ = √(1/fan_in)/0.8796), biases zero. Keeps
    activations in range through VGG16's 13 convolutions."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            nn.init.zeros_(m.bias)
    return model
