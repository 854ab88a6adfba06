"""Classifier data pipeline: dataset split, image loading, augmentation (the
JAX package's ``models/data.py``).

Reproduces the semantics of the reference notebook
(Main_FYP_DCNN_training.ipynb):

  * cells 14/16 — :func:`split_dataset`: a seeded 70/15/15 split per
    class; the same seed gives the JAX package's file lists;
  * cell 17 — Keras ``ImageDataGenerator``: train = rescale 1/255 +
    rotation ±20° + width/height shift ±0.2 + shear 0.2 + zoom ±0.2 +
    horizontal flip; val/test = rescale only; images 224×224, binary
    labels. Images are decoded and resized on the host with PIL.

The augmentation is one batched affine warp on the images' device:
:func:`affine_matrices` composes the seven random draws into one inverse
map per image as the JAX package does, and :func:`warp` applies it as a
bilinear gather with Keras' "nearest" fill.

A data-parallel rank holds a slice of each global batch: it hands the
augmentation (and the classifier's dropout) a :class:`BatchShard`, whose
draws are made for the whole batch from the shared generator and cut to
the rank's rows, so the ranks together draw what one process would.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Sequence

import numpy as np
import torch

IMAGE_SIZE = (224, 224)
IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg")


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """Draws from ``generator`` for a global batch of ``size`` rows, of
    which the caller holds the rows from ``start`` on."""

    generator: torch.Generator
    size: int
    start: int


def rand_rows(generator: torch.Generator | BatchShard | None, shape: tuple,
              device: torch.device) -> torch.Tensor:
    """``torch.rand(shape)`` drawn from ``generator``; for a BatchShard,
    rows [start, start + shape[0]) of the draw for its whole batch."""
    if isinstance(generator, BatchShard):
        full = torch.rand((generator.size, *shape[1:]),
                          generator=generator.generator, device=device)
        return full[generator.start:generator.start + shape[0]]
    return torch.rand(shape, generator=generator, device=device)


def split_dataset(
    items: Sequence, seed: int = 42,
    fractions: tuple[float, float, float] = (0.7, 0.15, 0.15),
):
    """Deterministic 70/15/15 split of one class's item list (cell 14)."""
    items = list(items)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(items))
    n = len(items)
    n_train = int(round(fractions[0] * n))
    n_val = int(round(fractions[1] * n))
    train = [items[i] for i in order[:n_train]]
    val = [items[i] for i in order[n_train : n_train + n_val]]
    test = [items[i] for i in order[n_train + n_val :]]
    return train, val, test


def merge_class_folders(
    sources: Sequence[str],
) -> list[tuple[str, str]]:
    """Merge several source folders of one class into one logical list with
    collision-free renames (notebook cell 12's combined-folders variant).
    Renames are deterministic — ``<folderidx>_<filename>`` — so splits are
    reproducible. Only image files are merged. Returns (source_path,
    merged_name) pairs; nothing is copied."""
    merged: list[tuple[str, str]] = []
    for fi, src in enumerate(sources):
        for fname in sorted(os.listdir(src)):
            spath = os.path.join(src, fname)
            if not os.path.isfile(spath):
                continue
            if not fname.lower().endswith(IMAGE_EXTENSIONS):
                continue
            merged.append((spath, f"{fi}_{fname}"))
    return merged


def split_dataset_combined_folders(
    class_sources: dict[str, Sequence[str]],
    out_root: str,
    seed: int = 42,
    fractions: tuple[float, float, float] = (0.7, 0.15, 0.15),
) -> dict[str, dict[str, list[str]]]:
    """Cell 12/14 combined: merge each class's source folders, then build an
    ``out_root/{train,val,test}/<class>/`` tree with a per-class seeded
    70/15/15 split, each image copied once. An existing train/val/test tree
    under ``out_root`` is removed first, so a re-run cannot leave stale
    files that leak between train and test. Returns {split: {class:
    [paths]}}."""
    for split in ("train", "val", "test"):
        shutil.rmtree(os.path.join(out_root, split), ignore_errors=True)
    result: dict[str, dict[str, list[str]]] = {
        s: {} for s in ("train", "val", "test")
    }
    for cname, sources in sorted(class_sources.items()):
        merged = merge_class_folders(sources)
        train, val, test = split_dataset(merged, seed=seed, fractions=fractions)
        for split, files in (("train", train), ("val", val), ("test", test)):
            sdir = os.path.join(out_root, split, cname)
            os.makedirs(sdir, exist_ok=True)
            placed = []
            for src, merged_name in files:
                dst = os.path.join(sdir, merged_name)
                shutil.copyfile(src, dst)
                placed.append(dst)
            result[split][cname] = placed
    return result


def load_image(path: str, size=IMAGE_SIZE) -> np.ndarray:
    """Load + resize one RGB image to float32 [0, 1] (rescale=1/255)."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize(size[::-1], Image.BILINEAR)
        return np.asarray(im, np.float32) / 255.0


def load_image_folder(
    root: str, classes: Sequence[str] | None = None, size=IMAGE_SIZE,
):
    """Load a flow_from_directory-style tree: root/<class>/*.png.

    Returns (images [N, H, W, 3] float32 in [0,1], labels [N] float32,
    class_names). Binary class indices follow sorted class-name order
    (Keras convention).
    """
    classes = sorted(classes or [
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    ])
    images, labels = [], []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(root, cname)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")):
                images.append(load_image(os.path.join(cdir, fname), size))
                labels.append(float(ci))
    if not images:
        raise ValueError(f"no images under {root}")
    return np.stack(images), np.asarray(labels, np.float32), classes


def affine_matrices(theta: torch.Tensor, ty: torch.Tensor, tx: torch.Tensor,
                    shear: torch.Tensor, zy: torch.Tensor, zx: torch.Tensor,
                    flip: torch.Tensor) -> torch.Tensor:
    """Inverse (output → source) affine maps [N, 2, 3] from per-image draws
    [N]: rotation ``theta`` in radians, shifts ``ty``/``tx`` in pixels,
    ``shear``, zooms ``zy``/``zx`` and ``flip`` (±1), composed as Keras'
    apply_affine_transform does (the JAX package's ``augment_batch``). The
    flip scales all of row 1, the x shift included."""
    cos, sin = torch.cos(theta), torch.sin(theta)
    m00 = cos / zy
    m01 = sin / zy
    m10 = (-sin + shear * cos) / zx * flip
    m11 = (cos + shear * sin) / zx * flip
    return torch.stack([torch.stack([m00, m01, ty], dim=-1),
                        torch.stack([m10, m11, tx * flip], dim=-1)], dim=-2)


def warp(images: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """Bilinear warp of NHWC ``images`` by one 2×3 matrix each about the
    image centre ((h−1)/2, (w−1)/2; row 0 maps y, row 1 maps x). Source
    coordinates are clamped to the image before the lookup: Keras'
    "nearest" fill, ImageDataGenerator's default."""
    n, h, w, _ = images.shape
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=images.device),
        torch.arange(w, dtype=torch.float32, device=images.device),
        indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    y, x = yy - cy, xx - cx
    m = mats.to(torch.float32)[:, :, :, None, None]  # [N, 2, 3, 1, 1]
    src_y = (m[:, 0, 0] * y + m[:, 0, 1] * x + m[:, 0, 2] + cy).clamp(0.0, h - 1.0)
    src_x = (m[:, 1, 0] * y + m[:, 1, 1] * x + m[:, 1, 2] + cx).clamp(0.0, w - 1.0)
    y0f, x0f = torch.floor(src_y), torch.floor(src_x)
    y0, x0 = y0f.long(), x0f.long()
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    fy, fx = (src_y - y0f)[..., None], (src_x - x0f)[..., None]
    b = torch.arange(n, device=images.device)[:, None, None]
    v00, v01 = images[b, y0, x0], images[b, y0, x1]
    v10, v11 = images[b, y1, x0], images[b, y1, x1]
    return (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx) + v11 * fy * fx)


def augment_batch(
    generator: torch.Generator | BatchShard,
    images: torch.Tensor,
    *,
    rotation_deg: float = 20.0,
    shift: float = 0.2,
    shear: float = 0.2,
    zoom: float = 0.2,
    horizontal_flip: bool = True,
) -> torch.Tensor:
    """Keras-ImageDataGenerator-style random affine augmentation (cell 17),
    batched: one random affine per image of ``images`` [N, H, W, C]
    float32, drawn from ``generator`` (on the images' device; a
    BatchShard for a rank's slice of a global batch) and applied as one
    bilinear warp."""
    n, h, w, _ = images.shape

    def uniform(lo, hi):
        return rand_rows(generator, (n,), images.device) * (hi - lo) + lo

    theta = torch.deg2rad(uniform(-rotation_deg, rotation_deg))
    ty = uniform(-shift, shift) * h
    tx = uniform(-shift, shift) * w
    shear_r = uniform(-shear, shear)
    zy = uniform(1 - zoom, 1 + zoom)
    zx = uniform(1 - zoom, 1 + zoom)
    if horizontal_flip:
        flip = (rand_rows(generator, (n,), images.device) < 0.5
                ).to(torch.float32) * -2.0 + 1.0
    else:
        flip = torch.ones(n, device=images.device)
    return warp(images, affine_matrices(theta, ty, tx, shear_r, zy, zx, flip))
