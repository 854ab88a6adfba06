"""Classifier training: Adam, frozen-backbone masking, checkpoints (the JAX
package's ``models/train.py``).

Mirrors Main_FYP_DCNN_training.ipynb cells 19-29: Adam lr=1e-4, binary
cross-entropy, accuracy metric, 10 epochs, batch 32; checkpoints (the .h5
``model2.save`` equivalent, cells 21-23); evaluation gives loss/accuracy
plus a confusion matrix (cells 25/29).

As in the JAX package:
  * the optimizer is optax's chain: an optional global-norm clip, then
    Adam (β 0.9/0.999, ε 1e-8). With ``freeze_backbone`` only the head's
    parameters enter it, so the clip's norm is taken over them alone and
    the backbone has no Adam state; the backbone's gradients are not
    computed at all (``requires_grad`` off), which changes no result;
  * the host loop draws the batch order from a fresh
    ``np.random.default_rng(seed)`` on every ``fit``, so the batches are
    the JAX package's;
  * checkpoints hold the parameters in the Flax layout (``params.npz``,
    models/params.py), which the inference artifact and the JAX package's
    tree both use.

Augmentation and dropout draw from two ``torch.Generator``s on the
training device, seeded from ``TrainConfig.seed``; a full-state
checkpoint keeps both.

With a ``mesh`` (parallel/mesh.py) the step is data-parallel over its
``data`` axis, as the JAX Trainer's is: the parameters are replicated
(every rank initializes them from the same seed), every rank draws the
same batch order and takes its rows of each global batch (whose size must
divide by the axis size, as JAX's sharding requires), the augmentation and
dropout draws are made for the global batch and cut to those rows
(models/data.py::BatchShard), and the loss, accuracy and gradients are
all-reduced to their global-batch means before the clip and Adam. A DP
step is then the one-process step on the global batch, up to the order of
the gradient sums.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fmcw_radar_processing_tpu_torch.models.data import BatchShard, augment_batch
from fmcw_radar_processing_tpu_torch.models.params import (
    flatten_tree,
    params_from_flax,
    state_dict_to_flax,
    unflatten_tree,
)
from fmcw_radar_processing_tpu_torch.models.vgg import build_model, init_flax_default_
from fmcw_radar_processing_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from fmcw_radar_processing_tpu_torch.utils.cplx import resolve_device

PARAMS_FILENAME = "params.npz"
STATE_FILENAME = "train_state.pt"
HISTORY_FILENAME = "history.json"
EVAL_CHUNK = 64  # images per forward in evaluate()


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4  # notebook cell 19
    epochs: int = 10  # cell 21
    batch_size: int = 32  # cell 17
    freeze_backbone: bool = False  # transfer-learning mode (cell 19)
    augment: bool = True  # train-split augmentation (cell 17)
    seed: int = 42
    # Global-norm gradient clipping (None = off, the notebook's setting).
    # From-scratch training of the plain 16-layer VGG stack needs it:
    # unclipped, the first steps blow the activations up and the net
    # collapses to constant logits (loss pinned at ln 2).
    grad_clip_norm: float | None = None


class Optimizer:
    """optax's ``chain(clip_by_global_norm(c), adam(lr))`` over a list of
    parameters (their ``.grad``), as :func:`make_optimizer` builds it."""

    def __init__(self, params: list[nn.Parameter], learning_rate: float,
                 clip_norm: float | None):
        self.params = params
        self.clip_norm = clip_norm
        self.adam = torch.optim.Adam(params, lr=learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.clip_norm:
            clip_by_global_norm_(self.params, self.clip_norm)
        self.adam.step()

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)


@torch.no_grad()
def clip_by_global_norm_(params: list[nn.Parameter], max_norm: float) -> None:
    """optax.clip_by_global_norm on the gradients, in place: when their
    global norm g reaches ``max_norm`` each becomes t / g · max_norm (not
    clip_grad_norm_'s max_norm / (g + 1e-6)). No host synchronization."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def make_optimizer(config: TrainConfig, model: nn.Module) -> Optimizer:
    """The optimizer of ``model`` under ``config``. With
    ``freeze_backbone`` the parameters under ``backbone.`` (VGG16's; a
    SmallCNN has none) get ``requires_grad`` off and stay out of it."""
    trainable = []
    for name, p in model.named_parameters():
        frozen = config.freeze_backbone and name.split(".")[0] == "backbone"
        p.requires_grad_(not frozen)
        if not frozen:
            trainable.append(p)
    return Optimizer(trainable, config.learning_rate, config.grad_clip_norm)


def binary_loss_and_metrics(logits: torch.Tensor, labels: torch.Tensor):
    """Mean sigmoid binary cross-entropy and accuracy at threshold 0.5
    (cell 25), as device scalars."""
    loss = F.binary_cross_entropy_with_logits(logits, labels)
    pred = (torch.sigmoid(logits) > 0.5).to(torch.float32)
    acc = (pred == labels).to(torch.float32).mean()
    return loss, acc


def make_train_step(model: nn.Module, optimizer: Optimizer,
                    mesh: Mesh | None = None):
    """step(images [B,H,W,C], labels [B], dropout generator) ->
    {'loss', 'accuracy'} as device scalars: a forward with dropout on, the
    backward, then the optimizer. No host synchronization on one process.

    With a ``mesh`` the images and labels are this rank's rows of the
    global batch (the same count on every rank of the ``data`` axis), and
    the gradients, loss and accuracy are averaged over the axis (one
    all-reduce of the flattened gradients) before the optimizer."""
    n = mesh.shape[DATA_AXIS] if mesh is not None else 1

    def step(images: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator | BatchShard) -> dict[str, torch.Tensor]:
        optimizer.zero_grad()
        logits = model(images, train=True, generator=generator)
        loss, acc = binary_loss_and_metrics(logits, labels)
        loss.backward()
        loss = loss.detach()
        if n > 1:
            grads = [p.grad for p in optimizer.params]
            flat = torch.cat([g.reshape(-1) for g in grads] + [loss[None], acc[None]])
            flat = mesh.psum(flat, DATA_AXIS) / n
            off = 0
            for g in grads:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()
            loss, acc = flat[off], flat[off + 1]
        optimizer.step()
        return {"loss": loss, "accuracy": acc}

    return step


def make_eval_step(model: nn.Module):
    """step(images, labels) -> (loss, accuracy, sigmoid probabilities)."""

    @torch.no_grad()
    def step(images: torch.Tensor, labels: torch.Tensor):
        logits = model(images)
        loss, acc = binary_loss_and_metrics(logits, labels)
        return loss, acc, torch.sigmoid(logits)

    return step


class Trainer:
    """Host training loop + checkpointing for a binary spectrogram
    classifier: ``model_name`` ("vgg16" or "small", with ``model_kwargs``
    such as VGG16's ``blocks`` or ``dtype``) built for ``input_shape`` on
    ``device`` (the card unless the caller asks for "cpu"; "cuda" without
    a card raises RuntimeError), with Flax's default initialization drawn
    from a generator seeded by ``config.seed``. ``mesh`` makes the step
    data-parallel over its ``data`` axis (the module docstring)."""

    def __init__(
        self,
        model_name: str,
        config: TrainConfig | None = None,
        input_shape: tuple[int, int, int] = (224, 224, 3),
        device: torch.device | str = "cuda",
        mesh: Mesh | None = None,
        **model_kwargs,
    ):
        self.config = config or TrainConfig()
        self.device = resolve_device(device)
        self.mesh = mesh
        self.model_name = model_name
        self.input_shape = tuple(input_shape)
        self.model_kwargs = model_kwargs
        self.model = build_model(model_name, self.input_shape, device="meta",
                                 **model_kwargs).to_empty(device=self.device)
        seed = self.config.seed
        init_flax_default_(self.model,
                           torch.Generator(self.device).manual_seed(seed))
        self.aug_generator = torch.Generator(self.device).manual_seed(seed + 1)
        self.drop_generator = torch.Generator(self.device).manual_seed(seed + 2)
        self.optimizer = make_optimizer(self.config, self.model)
        self._train_step = make_train_step(self.model, self.optimizer, mesh)
        self._eval_step = make_eval_step(self.model)
        self.step = 0
        self.history: list[dict[str, float]] = []

    @property
    def params(self) -> dict:
        """The parameters as a Flax-layout tree of float32 arrays."""
        return state_dict_to_flax(self.model.state_dict())

    def _batches(self, n: int, rng: np.random.Generator):
        order = rng.permutation(n)
        b = self.config.batch_size
        # steps_per_epoch = n // b (notebook cell 21 `samples // 32`).
        for s in range(max(n // b, 1) if n >= b else 1):
            yield order[s * b : (s + 1) * b]

    def _shard(self, batch_idx: np.ndarray):
        """(augmentation draws, dropout draws, this rank's rows) of one
        global batch: the generators and the batch as they are on one
        process; under a mesh, BatchShards and the rank's contiguous rows
        (ValueError when the batch does not divide by the data axis)."""
        n = self.mesh.shape[DATA_AXIS] if self.mesh is not None else 1
        if n == 1:
            return self.aug_generator, self.drop_generator, batch_idx
        b = len(batch_idx)
        if b % n:
            raise ValueError(f"global batch {b} not divisible by the data "
                             f"axis ({n})")
        start = self.mesh.index(DATA_AXIS) * (b // n)
        return (BatchShard(self.aug_generator, b, start),
                BatchShard(self.drop_generator, b, start),
                batch_idx[start:start + b // n])

    def fit(
        self, images: np.ndarray, labels: np.ndarray,
        val: tuple[np.ndarray, np.ndarray] | None = None,
        epochs: int | None = None,
        log_fn: Callable[[str], None] | None = None,
    ):
        epochs = epochs or self.config.epochs
        rng = np.random.default_rng(self.config.seed)
        x_all = torch.as_tensor(np.asarray(images, np.float32)).to(self.device)
        y_all = torch.as_tensor(np.asarray(labels, np.float32)).to(self.device)
        for epoch in range(epochs):
            losses, accs = [], []
            t0 = time.perf_counter()
            for batch_idx in self._batches(len(images), rng):
                aug, drop, batch_idx = self._shard(batch_idx)
                idx = torch.as_tensor(batch_idx).to(self.device)
                x, y = x_all[idx], y_all[idx]
                if self.config.augment:
                    x = augment_batch(aug, x)
                metrics = self._train_step(x, y, drop)
                self.step += 1
                losses.append(float(metrics["loss"]))
                accs.append(float(metrics["accuracy"]))
            # Step-loop wall time only (the float(metrics) pulls sync every
            # step); validation passes are outside.
            train_seconds = time.perf_counter() - t0
            entry = {
                "epoch": epoch + 1,
                "loss": float(np.mean(losses)),
                "accuracy": float(np.mean(accs)),
                "steps": len(losses),
                "train_seconds": round(train_seconds, 4),
            }
            if val is not None:
                vloss, vacc, _ = self.evaluate(*val)
                entry.update({"val_loss": vloss, "val_accuracy": vacc})
            self.history.append(entry)
            if log_fn:
                log_fn(str(entry))
        return self.history

    def evaluate(self, images: np.ndarray, labels: np.ndarray):
        """Full-dataset loss/accuracy/probabilities, in forwards of at most
        ``EVAL_CHUNK`` images (each image's result does not depend on the
        chunking)."""
        probs, loss_sum, acc_sum = [], 0.0, 0.0
        for i in range(0, len(images), EVAL_CHUNK):
            x = torch.as_tensor(np.asarray(images[i:i + EVAL_CHUNK], np.float32))
            y = torch.as_tensor(np.asarray(labels[i:i + EVAL_CHUNK], np.float32))
            loss, acc, p = self._eval_step(x.to(self.device), y.to(self.device))
            loss_sum += float(loss) * len(y)
            acc_sum += float(acc) * len(y)
            probs.append(p.float().cpu().numpy())
        probs = np.concatenate(probs)
        return loss_sum / len(probs), acc_sum / len(probs), probs

    def confusion_matrix(self, images: np.ndarray, labels: np.ndarray):
        """2×2 confusion matrix at threshold 0.5 (notebook cells 25/29)."""
        _, _, probs = self.evaluate(images, labels)
        pred = (probs > 0.5).astype(int)
        y = labels.astype(int)
        cm = np.zeros((2, 2), int)
        for t, p in zip(y, pred):
            cm[t, p] += 1
        return cm

    def classification_report(
        self, images: np.ndarray, labels: np.ndarray,
        class_names: tuple[str, str] = ("0", "1"),
    ) -> dict:
        """Per-class precision/recall/F1/support at threshold 0.5 — the
        sklearn ``classification_report`` the notebook prints (cells 25/29),
        as a dict (keys per class plus 'accuracy')."""
        cm = self.confusion_matrix(images, labels)
        report: dict = {}
        for c, name in enumerate(class_names):
            tp = cm[c, c]
            fp = cm[1 - c, c]
            fn = cm[c, 1 - c]
            prec = tp / (tp + fp) if tp + fp else 0.0
            rec = tp / (tp + fn) if tp + fn else 0.0
            f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
            report[name] = {
                "precision": round(float(prec), 4),
                "recall": round(float(rec), 4),
                "f1": round(float(f1), 4),
                "support": int(cm[c].sum()),
            }
        report["accuracy"] = round(float(np.trace(cm) / max(cm.sum(), 1)), 4)
        return report

    def set_params(self, params):
        """Replace the model parameters in place from a Flax-layout tree
        (a JAX-trained model's, or Keras-imported pretrained weights from
        models/import_keras.py — the notebook's ``VGG16(weights=
        'imagenet')`` setup, cell 19). The optimizer keeps its state;
        with ``freeze_backbone=True`` this is the reference's transfer
        learning."""
        state = params_from_flax(self.model_name, params, self.input_shape,
                                 **self.model_kwargs)
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(state[name])
        return self

    # ------------- checkpointing (the .h5 save/load equivalent) -------------

    def save(self, path: str):
        """The parameters, Flax layout, as ``path/params.npz``."""
        os.makedirs(path, exist_ok=True)
        leaves = {k: np.asarray(v, np.float32)
                  for k, v in flatten_tree(self.params).items()}
        np.savez(os.path.join(path, PARAMS_FILENAME), **leaves)

    def load(self, path: str):
        with np.load(os.path.join(path, PARAMS_FILENAME)) as z:
            return self.set_params(unflatten_tree({k: z[k] for k in z.files}))

    # ------------- full resume (beyond the reference's .h5) -------------
    # The reference checkpoints weights only (notebook cells 21-23).
    # Resume needs params + optimizer state + step + generators + history.

    def save_state(self, path: str):
        self.save(path)
        torch.save({
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "aug_generator": self.aug_generator.get_state(),
            "drop_generator": self.drop_generator.get_state(),
        }, os.path.join(path, STATE_FILENAME))
        with open(os.path.join(path, HISTORY_FILENAME), "w") as f:
            json.dump(self.history, f)

    def load_state(self, path: str):
        state_path = os.path.join(path, STATE_FILENAME)
        if not os.path.exists(state_path):
            raise FileNotFoundError(f"{state_path} not found — not a train "
                                    "state (write one with save_state)")
        self.load(path)
        state = torch.load(state_path, map_location="cpu", weights_only=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.aug_generator.set_state(state["aug_generator"])
        self.drop_generator.set_state(state["drop_generator"])
        hist = os.path.join(path, HISTORY_FILENAME)
        if os.path.exists(hist):
            with open(hist) as f:
                self.history = json.load(f)
        return self
