"""Host image loading for classifier inference (the JAX package's
``models/data.py``, inference half).

Images are decoded and resized on the host with PIL and scaled by 1/255,
the notebook's test-time ``ImageDataGenerator(rescale=1./255)``
(Main_FYP_DCNN_training.ipynb cell 17). The dataset split and the
training augmentation belong to training, which is not ported yet
(ROADMAP.md, Queue 1 item 10).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

IMAGE_SIZE = (224, 224)


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
