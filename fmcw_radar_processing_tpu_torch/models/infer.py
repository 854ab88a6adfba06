"""Classifier inference — "AI classification through API calls" (the JAX
package's ``models/infer.py``).

  * A self-describing artifact directory: ``params.npz`` (the Flax-layout
    parameter tree, one array per ``a/b/kernel`` path, float32) and
    ``meta.json`` (model family, input shape, class names), the JAX
    artifact's schema. The JAX package writes its parameters with orbax,
    which cannot be read without jax; this format can be read by both.
  * A batched forward on one device. Request batches are padded to
    power-of-two buckets (≤ 64) and larger ones run in chunks of 64, as in
    JAX, so an image's result does not depend on how many others share
    its batch; compute is bfloat16 (models/vgg.py).
  * PNG/JPEG decode + resize on the host (PIL), normalization 1/255.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch

from fmcw_radar_processing_tpu_torch.models.data import load_image
from fmcw_radar_processing_tpu_torch.models.params import (
    flatten_tree,
    params_from_flax,
    unflatten_tree,
)
from fmcw_radar_processing_tpu_torch.models.vgg import MODELS, build_model

META_FILENAME = "meta.json"
PARAMS_FILENAME = "params.npz"
MAX_BATCH_BUCKET = 64


def export_classifier(
    path: str,
    model_name: str,
    params,
    input_shape: tuple[int, int, int],
    classes: Sequence[str],
) -> str:
    """Write a self-describing inference artifact (params + meta.json).

    params: the Flax-layout tree of arrays (a JAX-trained model's params,
    or ``models.params.state_dict_to_flax`` of a port model). It is checked
    against the model before anything is written."""
    if model_name not in MODELS:
        raise ValueError(f"unknown model {model_name!r}; one of {sorted(MODELS)}")
    if len(classes) != 2:
        raise ValueError("binary classifier artifact needs exactly 2 classes")
    params_from_flax(model_name, params, input_shape)
    os.makedirs(path, exist_ok=True)
    leaves = {k: np.asarray(v, np.float32)
              for k, v in flatten_tree(params).items()}
    np.savez(os.path.join(path, PARAMS_FILENAME), **leaves)
    with open(os.path.join(path, META_FILENAME), "w") as f:
        json.dump({
            "model": model_name,
            "input_shape": list(input_shape),
            "classes": list(classes),
            "normalization": "1/255",
        }, f, indent=2)
    return path


def _bucket(n: int) -> int:
    b = 1
    while b < n and b < MAX_BATCH_BUCKET:
        b *= 2
    return b


class SpectrogramClassifier:
    """Loads an exported artifact and serves batched predictions on one
    device.

    Requests of any size are padded up to the nearest power-of-two bucket
    (≤ 64) and larger batches run in bucket-sized chunks, so a service sees
    only seven batch shapes, each warmed at start (:meth:`warmup`).
    """

    def __init__(self, model_name: str, params,
                 input_shape: tuple[int, int, int],
                 classes: Sequence[str], device: torch.device | str = "cpu"):
        if model_name not in MODELS:
            raise ValueError(f"unknown model {model_name!r}; one of "
                             f"{sorted(MODELS)}")
        self.model_name = model_name
        self.input_shape = tuple(input_shape)
        self.classes = tuple(classes)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but "
                               "torch.cuda.is_available() is False")
        state = params_from_flax(model_name, params, self.input_shape)
        self.model = build_model(model_name, self.input_shape, device=self.device)
        self.model.load_state_dict(state)

    def _forward(self, images: np.ndarray) -> np.ndarray:
        """Sigmoid probabilities of one bucket-sized batch."""
        with torch.inference_mode():
            x = torch.as_tensor(images).to(self.device)
            return torch.sigmoid(self.model(x)).float().cpu().numpy()

    def warmup(self, max_bucket: int = MAX_BATCH_BUCKET) -> None:
        """Run the forward at every batch bucket ≤ max_bucket, so that no
        request pays the first call of a shape (library initialization and
        algorithm selection). Called at service start
        (serve/http_service.py)."""
        b = 1
        while b <= max_bucket:
            self._forward(np.zeros((b, *self.input_shape), np.float32))
            b *= 2

    # ------------------------------ loading ------------------------------

    @classmethod
    def load(cls, path: str, device: torch.device | str = "cpu"
             ) -> "SpectrogramClassifier":
        meta_path = os.path.join(path, META_FILENAME)
        if not os.path.exists(meta_path):
            raise FileNotFoundError(
                f"{meta_path} not found — not a classifier artifact "
                "(export one with export_classifier)"
            )
        with open(meta_path) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, PARAMS_FILENAME)) as z:
            params = unflatten_tree({k: z[k] for k in z.files})
        return cls(meta["model"], params, tuple(meta["input_shape"]),
                   meta["classes"], device)

    # ----------------------------- prediction ----------------------------

    def predict_proba(self, images: np.ndarray) -> np.ndarray:
        """Sigmoid probabilities of class 1 for NHWC float images in [0,1]."""
        images = np.asarray(images, np.float32)
        if images.ndim == 3:
            images = images[None]
        if images.shape[1:] != self.input_shape:
            raise ValueError(
                f"expected images of shape {self.input_shape}, "
                f"got {images.shape[1:]}"
            )
        n = images.shape[0]
        probs = np.empty(n, np.float32)
        done = 0
        while done < n:
            take = min(n - done, MAX_BATCH_BUCKET)
            b = _bucket(take)
            chunk = images[done:done + take]
            if take < b:  # pad up to the bucket; padded rows are discarded
                chunk = np.concatenate(
                    [chunk, np.zeros((b - take, *self.input_shape), np.float32)]
                )
            probs[done:done + take] = self._forward(chunk)[:take]
            done += take
        return probs

    def classify(self, images: np.ndarray) -> list[dict]:
        """Label + probability per image (threshold 0.5, notebook cells 25/29)."""
        probs = self.predict_proba(images)
        out = []
        for p in probs:
            idx = int(p > 0.5)
            out.append({
                "label": self.classes[idx],
                "class_index": idx,
                "probability": round(float(p if idx else 1.0 - p), 6),
                "score": round(float(p), 6),
            })
        return out

    # --------------------------- image ingestion -------------------------

    def decode_image_bytes(self, data: bytes) -> np.ndarray:
        """PNG/JPEG bytes → normalized HWC float array at the model size."""
        import io

        from PIL import Image

        h, w = self.input_shape[:2]
        with Image.open(io.BytesIO(data)) as im:
            im = im.convert("RGB").resize((w, h), Image.BILINEAR)
            return np.asarray(im, np.float32) / 255.0

    def classify_bytes(self, blobs: Sequence[bytes]) -> list[dict]:
        imgs = np.stack([self.decode_image_bytes(b) for b in blobs])
        return self.classify(imgs)

    def classify_files(self, paths: Sequence[str]) -> list[dict]:
        imgs = np.stack([load_image(p, self.input_shape[:2]) for p in paths])
        results = self.classify(imgs)
        for path, r in zip(paths, results):
            r["file"] = path
        return results
