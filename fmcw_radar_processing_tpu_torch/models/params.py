"""Carry classifier weights between the Flax layout and a ``state_dict``.

The JAX package keeps a model's parameters as a Flax tree:
``backbone/block{b}_conv{c}/{kernel,bias}`` and ``head/{fc,out}/...`` for
VGG16, ``Conv_0..3`` and ``Dense_0..1`` for SmallCNN, with convolution
kernels [3, 3, Cin, Cout] and dense kernels [in, out]. The port's modules
(models/vgg.py) use the same names, so a leaf ``a/b/kernel`` is the
``state_dict`` entry ``a.b.weight``, transposed to [Cout, Cin, 3, 3] or
[out, in].
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from fmcw_radar_processing_tpu_torch.models.vgg import build_model

_LEAF_TO_PARAM = {"kernel": "weight", "bias": "bias"}
_PARAM_TO_LEAF = {v: k for k, v in _LEAF_TO_PARAM.items()}


def flatten_tree(tree: Mapping, prefix: str = "") -> dict[str, object]:
    """Nested mapping → {"a/b/kernel": leaf}."""
    out: dict[str, object] = {}
    for name, value in tree.items():
        path = f"{prefix}{name}"
        if isinstance(value, Mapping):
            out.update(flatten_tree(value, path + "/"))
        else:
            out[path] = value
    return out


def unflatten_tree(leaves: Mapping[str, object]) -> dict:
    """{"a/b/kernel": leaf} → nested dicts."""
    tree: dict = {}
    for path, leaf in leaves.items():
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def _flax_shape(shape: tuple[int, ...]) -> tuple[int, ...]:
    """Shape of the Flax leaf for a torch parameter of ``shape``."""
    if len(shape) == 4:  # [Cout, Cin, kh, kw] ← [kh, kw, Cin, Cout]
        return (shape[2], shape[3], shape[1], shape[0])
    if len(shape) == 2:  # [out, in] ← [in, out]
        return (shape[1], shape[0])
    return shape


def _to_torch_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 2:
        return a.T
    return a


def params_from_flax(model_name: str, tree: Mapping,
                     input_shape: tuple[int, int, int] = (224, 224, 3),
                     **model_kwargs) -> dict[str, torch.Tensor]:
    """The ``state_dict`` (float32 CPU tensors) of ``model_name`` built for
    ``input_shape`` (and ``model_kwargs``, such as VGG16's ``blocks``) from
    its Flax ``params`` tree of arrays. Every leaf is used exactly once; a
    missing, extra or wrongly shaped leaf raises ValueError."""
    want = {k: tuple(v.shape) for k, v in build_model(
        model_name, input_shape, device="meta", **model_kwargs
    ).state_dict().items()}
    out: dict[str, torch.Tensor] = {}
    for path, leaf in flatten_tree(tree).items():
        *parents, name = path.split("/")
        key = ".".join([*parents, _LEAF_TO_PARAM.get(name, name)])
        if name not in _LEAF_TO_PARAM or key not in want:
            raise ValueError(f"{model_name}: unexpected parameter {path!r}")
        a = np.asarray(leaf, np.float32)
        if a.shape != _flax_shape(want[key]):
            raise ValueError(f"{model_name}: {path!r} has shape {a.shape}, "
                             f"expected {_flax_shape(want[key])}")
        out[key] = torch.from_numpy(np.array(_to_torch_layout(a), order="C"))
    missing = sorted(k for k in want if k not in out)
    if missing:
        raise ValueError(f"{model_name}: missing parameters {missing}")
    return out


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`params_from_flax`: a nested Flax-layout tree of
    float32 NumPy arrays."""
    leaves = {}
    for key, t in state_dict.items():
        *parents, name = key.split(".")
        a = t.detach().to("cpu", torch.float32).numpy()
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        elif a.ndim == 2:
            a = a.T
        leaves["/".join([*parents, _PARAM_TO_LEAF[name]])] = np.ascontiguousarray(a)
    return unflatten_tree(leaves)
