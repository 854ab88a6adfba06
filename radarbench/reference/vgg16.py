"""The plain float32 reference of the VGG16 classifier.

Simonyan & Zisserman's configuration D (arXiv:1409.1556) as the
reference's notebook builds it (Main_FYP_DCNN_training.ipynb cell 19):
blocks of 3×3 'SAME' convolutions and ReLU, each block ending in a 2×2 /
2 max-pool; then Flatten in (H, W, C) order → Dense(256, ReLU) →
Dense(1), the logit. Dropout is the identity at inference. Written from
the Flax-layout tree of float32 leaves (``backbone/block{b}_conv{c}/
{kernel,bias}``, ``head/{fc,out}/{kernel,bias}``; kernels [3, 3, Cin,
Cout] and [in, out]) with ``F.conv2d``, ``F.max_pool2d`` and
``F.linear`` alone, in float32 with TF32 off, in blocks of images.

It takes images as the service decodes a body (the driver decodes them
with PIL, as the program does). Nothing here imports the program.

``features`` gives the first Dense's output (after its ReLU) of a pool of
images: the benchmark fits the last Dense to it (gen/weights.py,
``fit_readout``) before the program gets the weights.

``fp8=True`` gives the cell's control: the same forward with every
convolution's and Dense's weights and input rounded through
float8_e4m3fn at a per-tensor scale (the tensor's largest magnitude over
448, e4m3's largest value), the products still float32, as the card's
fp8 tensor cores would compute a forward one precision below bf16.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BLOCK_IMAGES = 16


class NoTf32:
    """float32 products in float32: TF32 off for matmuls and cuDNN, and
    cuDNN's deterministic algorithms, while the block runs; the settings
    restored afterwards."""

    FLAGS = ((torch.backends.cuda.matmul, "allow_tf32", False),
             (torch.backends.cudnn, "allow_tf32", False),
             (torch.backends.cudnn, "deterministic", True))

    def __enter__(self):
        self.old = [getattr(mod, name) for mod, name, _ in self.FLAGS]
        for mod, name, value in self.FLAGS:
            setattr(mod, name, value)

    def __exit__(self, *exc):
        for (mod, name, _), value in zip(self.FLAGS, self.old):
            setattr(mod, name, value)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8_e4m3fn at a per-tensor scale, back in
    float32."""
    scale = float(t.abs().max()) / 448.0 or 1.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Vgg16Ref:
    """The classifier of ``blocks`` ((convolutions, channels) per block)
    from ``params`` (the flat Flax-layout tree), on ``device``; with
    ``fp8`` each layer's weights and input rounded through e4m3."""

    def __init__(self, params: dict[str, np.ndarray], blocks, device, fp8: bool = False):
        self.blocks = [tuple(b) for b in blocks]
        self.device = torch.device(device)
        self.q = fp8_round if fp8 else (lambda t: t)

        def leaf(path):
            return torch.as_tensor(np.asarray(params[path], np.float32), device=self.device)

        self.convs = []
        for b, (convs, _) in enumerate(self.blocks):
            for c in range(convs):
                name = f"backbone/block{b + 1}_conv{c + 1}"
                self.convs.append((self.q(leaf(f"{name}/kernel").permute(3, 2, 0, 1)
                                          .contiguous()), leaf(f"{name}/bias")))
        self.fc = (self.q(leaf("head/fc/kernel").T.contiguous()), leaf("head/fc/bias"))
        self.out = (self.q(leaf("head/out/kernel").T.contiguous()), leaf("head/out/bias"))

    def _hidden(self, x: torch.Tensor) -> torch.Tensor:
        """The first Dense's output after its ReLU, of NHWC images ``x``."""
        q = self.q
        x = x.permute(0, 3, 1, 2)
        i = 0
        for convs, _ in self.blocks:
            for _ in range(convs):
                w, b = self.convs[i]
                x = F.relu(F.conv2d(q(x), w, b, padding=1))
                i += 1
            x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).flatten(1)
        return F.relu(F.linear(q(x), *self.fc))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.q(self._hidden(x)), *self.out)[:, 0]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """The logits of a batch of NHWC images on the device, as the
        program's model gives them: what the control serves."""
        with NoTf32(), torch.inference_mode():
            return self._logits(x.float())

    def _blocks(self, fn, images: np.ndarray) -> np.ndarray:
        outs = []
        with NoTf32(), torch.inference_mode():
            for s in range(0, len(images), BLOCK_IMAGES):
                x = torch.as_tensor(images[s:s + BLOCK_IMAGES], device=self.device)
                outs.append(fn(x.float()).double().cpu().numpy())
        return np.concatenate(outs)

    def logits(self, images: np.ndarray) -> np.ndarray:
        """The logits, float64 NumPy, of [N, H, W, 3] float32 images,
        computed BLOCK_IMAGES at a time."""
        return self._blocks(self._logits, images)

    def features(self, images: np.ndarray) -> np.ndarray:
        """[N, head] float64: the first Dense's output after its ReLU, of
        [N, H, W, 3] float32 images, BLOCK_IMAGES at a time."""
        return self._blocks(self._hidden, images)


def served_logit(score: float) -> float:
    """The logit a served probability of class 1 stands for; ±inf where
    the rounded score reached 0 or 1."""
    if score <= 0.0:
        return -np.inf
    if score >= 1.0:
        return np.inf
    return float(np.log(score / (1.0 - score)))


def score_quantum(logits: np.ndarray) -> float:
    """The most that rounding a score to 6 places (5e-7) moves the logit
    it stands for, at these logits: 5e-7 / (s·(1 − s))."""
    s = 1.0 / (1.0 + np.exp(-np.abs(np.asarray(logits, np.float64))))
    return float((5e-7 / (s * (1.0 - s))).max())


def check_answers(answers: list, classes, ref_logits: np.ndarray, per_request: int) -> dict:
    """The readings of served /classify answers against the reference.

    ``answers``: (body, status, response) per request, where body b sent
    the pool's images [b·per_request, (b + 1)·per_request).

      logit_err        the largest gap between a served score's logit and
                       the reference's logit of its image, over the
                       standard deviation of the reference's logits over
                       the pool: an answer given to another image of the
                       pool reads about 1;
      response_faults  requests not answered 200 "success", with another
                       number of predictions than images, other classes,
                       or a label, class index or probability that
                       disagrees with its own score.
    """
    scale = float(np.std(ref_logits))
    err, faults = 0.0, 0
    for body, status, response in answers:
        preds = response.get("predictions") if isinstance(response, dict) else None
        if (status != 200 or response.get("status") != "success"
                or list(response.get("classes", [])) != list(classes)
                or not isinstance(preds, list) or len(preds) != per_request
                or not all(_consistent(p, classes) for p in preds)):
            faults += 1
            continue
        for i, p in enumerate(preds):
            ref = ref_logits[body * per_request + i]
            err = max(err, abs(served_logit(float(p["score"])) - ref) / scale)
    return {"logit_err": float(err), "response_faults": faults}


def _consistent(p, classes) -> bool:
    """A prediction's label, class index and probability agree with its
    score (class 1 above 0.5, class 0 below; probability of the label)."""
    if not isinstance(p, dict) or p.get("class_index") not in (0, 1):
        return False
    try:
        s, prob = float(p["score"]), float(p["probability"])
    except (KeyError, TypeError, ValueError):
        return False
    idx = p["class_index"]
    return ((s > 0.5 and idx == 1) or (s < 0.5 and idx == 0) or s == 0.5) and (
        p.get("label") == classes[idx]
        and abs(prob - (s if idx == 1 else 1.0 - s)) <= 1.5e-6)
