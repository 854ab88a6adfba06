"""Keras-h5 → Flax-layout weight importer for the VGG16 classifier (the JAX
package's ``models/import_keras.py``).

The reference's classifier is transfer learning: ``VGG16(weights=
'imagenet', include_top=False)`` with a frozen backbone, saved as
``vgg16_custom_model_calf_human.h5`` (Main_FYP_DCNN_training.ipynb cells
19-23). This module brings Keras weights — the ImageNet backbone, or the
notebook's own trained artifact — into the Flax-layout parameter tree that
``Trainer.set_params``, ``export_classifier`` and ``params_from_flax``
take. No weights are downloaded: the caller names a local file.

Supported containers:
  * Keras HDF5, both flavors — a full ``model.save(...h5)`` file (weights
    under the ``model_weights`` group) and a ``save_weights`` file (layer
    groups at the root): ``<layer>/<layer>/kernel:0`` etc. ``h5py`` is
    imported only to read one;
  * an NPZ schema (for environments without h5py): flat keys
    ``<layer>/kernel`` and ``<layer>/bias`` — e.g. ``block1_conv1/kernel``
    with shape (3, 3, in, out).

Keras Conv2D kernels are HWIO and Dense kernels (in, out), exactly the
Flax layout, and Keras' ``Flatten`` of a channels-last map is the head's
(H, W, C) flatten, so the mapping is a rename: the 13 backbone convs keep
their Keras names (``block1_conv1`` … ``block5_conv3``) →
``backbone/block{b}_conv{c}``; the notebook's two head Dense layers (any
two Dense layers of the matching shapes) → ``head/fc`` and ``head/out``.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch


def _collect_h5_datasets(group, prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten an h5 group into {path: array} (datasets only)."""
    out: dict[str, np.ndarray] = {}
    for key in group:
        item = group[key]
        path = f"{prefix}{key}"
        if hasattr(item, "shape"):  # dataset
            out[path] = np.asarray(item)
        else:  # subgroup
            out.update(_collect_h5_datasets(item, path + "/"))
    return out


def _normalize_keys(flat: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Reduce h5/npz paths to ``<layer>/<kernel|bias>`` keys: the last
    directory component is the layer, the ``:0`` suffix is dropped."""
    out: dict[str, np.ndarray] = {}
    for path, arr in flat.items():
        parts = [p for p in path.split("/") if p]
        if not parts:
            continue
        weight = re.sub(r":\d+$", "", parts[-1])
        layer = parts[-2] if len(parts) >= 2 else ""
        out[f"{layer}/{weight}"] = arr
    return out


def load_keras_h5(path: str) -> dict[str, np.ndarray]:
    """Load a Keras .h5 (full-model or weights-only) into flat
    ``<layer>/<kernel|bias>`` arrays."""
    import h5py

    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        flat = _collect_h5_datasets(root)
    return _normalize_keys(flat)


def load_npz_weights(path: str) -> dict[str, np.ndarray]:
    """Load the NPZ schema (``<layer>/kernel``, ``<layer>/bias``)."""
    with np.load(path) as z:
        return _normalize_keys({k: z[k] for k in z.files})


_CONV_NAME = re.compile(r"^block(\d+)_conv(\d+)$")


def _numpy_tree(tree: Mapping) -> dict:
    return {k: _numpy_tree(v) if isinstance(v, Mapping) else np.asarray(v)
            for k, v in tree.items()}


def import_vgg16_params(
    template_params: Mapping,
    weights: dict[str, np.ndarray],
    *,
    import_head: bool = True,
    strict: bool = True,
):
    """Map Keras-layout weights onto a VGG16 Flax-layout param tree.

    template_params: a VGG16 parameter tree in the Flax layout (for
    example ``state_dict_to_flax`` of a port VGG16), which gives the
    structure, names and shapes.
    weights: flat dict from :func:`load_keras_h5` / :func:`load_npz_weights`.
    import_head: also fill ``head/fc`` and ``head/out`` from the file's
    Dense layers when present (the notebook's trained artifact); with only
    a backbone file the head keeps its template values (the
    transfer-learning setup of cell 19).
    strict: raise if any backbone conv is missing; False returns whatever
    could be mapped. A shape mismatch always raises.

    Returns (params, imported_names): a new tree of float32 arrays, and the
    Flax paths that were filled.
    """
    params = _numpy_tree(template_params)
    imported: list[str] = []

    def fill(tree_path: tuple[str, ...], arr: np.ndarray):
        node = params
        for k in tree_path[:-1]:
            node = node[k]
        leaf = tree_path[-1]
        want = node[leaf].shape
        if tuple(arr.shape) != tuple(want):
            raise ValueError(
                f"shape mismatch for {'/'.join(tree_path)}: "
                f"file has {tuple(arr.shape)}, model wants {tuple(want)}"
            )
        node[leaf] = arr.astype(np.float32)
        imported.append("/".join(tree_path))

    # --- backbone convs: canonical names, pure rename ---
    backbone = params["backbone"]
    missing = []
    for lname in backbone:
        if not _CONV_NAME.match(lname):
            continue
        k, b = weights.get(f"{lname}/kernel"), weights.get(f"{lname}/bias")
        if k is None or b is None:
            missing.append(lname)
            continue
        fill(("backbone", lname, "kernel"), k)
        fill(("backbone", lname, "bias"), b)
    if missing and strict:
        raise KeyError(
            f"backbone layers missing from weight file: {missing}; "
            f"file layers: {sorted({p.split('/')[0] for p in weights})}"
        )

    # --- head: the notebook's Dense(256) + Dense(1), if present ---
    if import_head:
        dense_layers = sorted(
            {p.split("/")[0] for p in weights
             if p.endswith("/kernel") and weights[p].ndim == 2}
        )
        head = params["head"]
        for flax_name in ("fc", "out"):
            want = tuple(head[flax_name]["kernel"].shape)
            # Match on the full (in, out) kernel shape: two Dense layers of
            # one width must not be told apart by name order.
            cands = [n for n in dense_layers
                     if tuple(weights[f"{n}/kernel"].shape) == want]
            if not cands:
                continue  # backbone-only file: head keeps template init
            if len(cands) > 1:
                raise ValueError(
                    f"ambiguous Dense layers for head/{flax_name} "
                    f"(kernel shape {want}): {cands} — rename layers in the "
                    f"weight file to disambiguate"
                )
            src = cands[0]
            fill(("head", flax_name, "kernel"), weights[f"{src}/kernel"])
            fill(("head", flax_name, "bias"), weights[f"{src}/bias"])

    return params, imported


def load_pretrained_vgg16(path: str, model: torch.nn.Module | None = None, *,
                          input_shape=(224, 224, 3), import_head=True):
    """Fill a VGG16 parameter tree from a Keras .h5 / .npz file.

    model: the port VGG16 whose current parameters are the template; by
    default a VGG16 for ``input_shape`` on the CPU with Flax's default
    initialization from a generator seeded 0. Returns (params,
    imported_names); the tree drops into ``Trainer.set_params`` (with
    ``freeze_backbone=True`` for the notebook's transfer setup) or
    ``export_classifier``.
    """
    from fmcw_radar_processing_tpu_torch.models.params import state_dict_to_flax
    from fmcw_radar_processing_tpu_torch.models.vgg import (
        build_model,
        init_flax_default_,
    )

    if model is None:
        model = init_flax_default_(build_model("vgg16", input_shape, "cpu"),
                                   torch.Generator().manual_seed(0))
    template = state_dict_to_flax(model.state_dict())
    weights = (
        load_npz_weights(path) if path.endswith(".npz") else load_keras_h5(path)
    )
    return import_vgg16_params(template, weights, import_head=import_head)
