"""PyTorch port: classifier training against the JAX package's
``models/train.py``.

Flax-initialized parameters of SmallCNN and of a two-block VGG16 (blocks
(1, 8), (1, 16), 16×16×3, float32 compute) are carried into the port.
The loss, accuracy and gradients must match ``jax.value_and_grad`` of
JAX's ``binary_loss_and_metrics``, and 1 and 3 optimizer steps must match
optax for the four shapes of ``make_optimizer`` (plain, clip, freeze,
freeze + clip). The port's steps run with the head's dropout rate at 0 and
JAX's with ``train=False``: dropout masks are drawn from different
generators, so only a dropout-off step can be compared. Then the JAX
tests' own properties: the batch order, a frozen backbone bit-unchanged,
learning separable data, the checkpoint round trip, a full-state resume
taking identical next steps, the classification report, and the CLI's
``train --export`` served by ``classify``.
"""

import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fmcw_radar_processing_tpu.models import train as jtrain
from fmcw_radar_processing_tpu.models.vgg import VGG16 as FlaxVGG16
from fmcw_radar_processing_tpu.models.vgg import SmallCNN as FlaxSmallCNN
from fmcw_radar_processing_tpu_torch.models import train as ttrain
from fmcw_radar_processing_tpu_torch.models.params import (
    flatten_tree,
    params_from_flax,
    state_dict_to_flax,
)
from fmcw_radar_processing_tpu_torch.models.train import TrainConfig, Trainer
from fmcw_radar_processing_tpu_torch.models.vgg import build_model
from fmcw_radar_processing_tpu_torch.serve.cli import main as cli_main

SHAPE = (16, 16, 3)
NARROW = ((1, 8), (1, 16))
MODELS = {"small": (FlaxSmallCNN, {}), "vgg16": (FlaxVGG16, {"blocks": NARROW})}
LR = 1e-3
# Gradients: float32 convolutions summed in another order; measured at most
# 1e-6·max|g| of a leaf apart.
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-4, 1e-5
# Adam's step is lr·m̂/(√v̂ + ε): where |g| is near rounding its sign can
# flip, which moves an element by up to 2·lr a step. Where |g| > 1e-4·max|g|
# (100× the measured gradient difference) the two must agree to 1e-2·lr
# (measured: at most 1e-3·lr after 3 steps).
CLEAR_SHARE, CLEAR_TOL = 1e-4, 1e-2 * LR


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: at these sizes it runs as fast as eight, and
    it does not oversubscribe the cores the test workers share (eight
    threads on a loaded machine ran the toy experiment 8× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flax(name, seed=1):
    cls, kw = MODELS[name]
    model = cls(dtype=jnp.float32, **kw)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, *SHAPE)),
                        train=False)["params"]
    return model, params


def _port(name, params):
    kw = MODELS[name][1]
    model = build_model(name, SHAPE, "cpu", dtype=torch.float32, **kw)
    model.load_state_dict(params_from_flax(name, params, SHAPE, **kw))
    return model


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(name):
    """jit(value_and_grad) of JAX's loss with dropout off, compiled once per
    model: (params, x, y) -> ((loss, accuracy), grads)."""
    fmodel = _flax(name)[0]

    def loss_fn(p, x, y):
        return jtrain.binary_loss_and_metrics(
            fmodel.apply({"params": p}, x, train=False), y)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _leaves(tree):
    return flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


def _batch(rng, n=8, size=SHAPE[0]):
    x = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    y[:2] = (0.0, 1.0)
    return x, y


def _toy_dataset(rng, n=64, size=32):
    """Separable binary 'spectrograms': class 1 has a bright band (the JAX
    tests' data)."""
    x = rng.uniform(0, 0.3, (n, size, size, 3)).astype(np.float32)
    y = (np.arange(n) % 2).astype(np.float32)
    x[y == 1, size // 4 : size // 2, :, :] += 0.6
    return x, y


# --- loss, gradients and optimizer steps against JAX ----------------------------


@pytest.mark.parametrize("name", sorted(MODELS))
def test_loss_and_gradients_match_jax(name):
    _, params = _flax(name)
    x, y = _batch(np.random.default_rng(0))
    (loss, acc), grads = _jax_value_and_grad(name)(params, x, y)
    model = _port(name, params)
    tloss, tacc = ttrain.binary_loss_and_metrics(model(torch.as_tensor(x)),
                                                 torch.as_tensor(y))
    tloss.backward()
    assert abs(float(tloss.detach()) - float(loss)) <= 1e-6 * abs(float(loss))
    assert float(tacc) == float(acc)
    got = flatten_tree(state_dict_to_flax(
        {k: p.grad for k, p in model.named_parameters()}))
    want = _leaves(grads)
    assert got.keys() == want.keys()
    for k, g in want.items():
        np.testing.assert_allclose(got[k], g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_SHARE * np.abs(g).max(), err_msg=k)


SHAPES = {"plain": (False, None), "clip": (False, 0.05),
          "freeze": (True, None), "freeze_clip": (True, 0.05)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_optimizer_steps_match_optax(name, shape):
    """1 and 3 steps of the port's make_train_step (dropout off) against
    optax's make_optimizer on JAX's gradients; the clip at 0.05 is active
    (the gradients' global norm is above it). With freeze the backbone is
    bit-unchanged on both sides (SmallCNN has no backbone: all trains)."""
    freeze, clip = SHAPES[shape]
    cfg = TrainConfig(learning_rate=LR, freeze_backbone=freeze, grad_clip_norm=clip)
    _, params = _flax(name)
    tx = jtrain.make_optimizer(jtrain.TrainConfig(
        learning_rate=LR, freeze_backbone=freeze, grad_clip_norm=clip), params)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    model = _port(name, params)
    if name == "vgg16":
        model.head.dropout = 0.0
    else:
        model.dropout = 0.0
    opt = ttrain.make_optimizer(cfg, model)
    n_trainable = sum(p.numel() for p in opt.params)
    n_head = sum(p.numel() for n, p in model.named_parameters()
                 if not n.startswith("backbone."))
    assert n_trainable == (n_head if freeze else sum(p.numel() for p in model.parameters()))
    step = ttrain.make_train_step(model, opt)
    before = _leaves(params)
    rng = np.random.default_rng(3)
    clear = None
    for s in range(3):
        x, y = _batch(rng)
        (loss, _), grads = _jax_value_and_grad(name)(params, x, y)
        g = _leaves(grads)
        if clear is None:
            clear = {k: np.abs(v) > CLEAR_SHARE * np.abs(v).max() for k, v in g.items()}
            if clip:
                assert np.sqrt(sum(float((v * v).sum()) for k, v in g.items()
                                   if not (freeze and k.startswith("backbone/")))) > clip
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        metrics = step(torch.as_tensor(x), torch.as_tensor(y), None)
        assert abs(float(metrics["loss"]) - float(loss)) <= 1e-5 * float(loss)
        if s in (0, 2):
            want = _leaves(params)
            got = flatten_tree(state_dict_to_flax(model.state_dict()))
            for k, w in want.items():
                d = np.abs(got[k] - w)
                assert d.max() <= 2 * LR * (s + 1), (s, k)
                assert d[clear[k]].max(initial=0.0) <= CLEAR_TOL, (s, k, d.max())
                if freeze and k.startswith("backbone/"):
                    assert np.array_equal(got[k], before[k])
                    assert np.array_equal(w, before[k])


def test_clip_is_optax_formula():
    """t / g · max_norm when the global norm g reaches max_norm, else the
    gradients unchanged (optax.clip_by_global_norm)."""
    rng = np.random.default_rng(2)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 2))]
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads)))
    for max_norm in (0.5 * norm, 2.0 * norm):
        params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.as_tensor(g.copy())
        ttrain.clip_by_global_norm_(params, max_norm)
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], optax.EmptyState())
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def test_batch_order_is_jax():
    """Trainer._batches: the same index batches as JAX's for a seed, the
    remainder dropped, one short batch when n < batch size."""
    for n, b in ((64, 16), (30, 7), (5, 8)):
        cfg = TrainConfig(batch_size=b)
        got = list(Trainer._batches(types.SimpleNamespace(config=cfg), n,
                                    np.random.default_rng(42)))
        want = list(jtrain.Trainer._batches(types.SimpleNamespace(config=cfg), n,
                                            np.random.default_rng(42)))
        assert [g.tolist() for g in got] == [w.tolist() for w in want]


# --- the JAX tests' properties ------------------------------------------------------


def test_training_learns_separable_data():
    x, y = _toy_dataset(np.random.default_rng(42))
    trainer = Trainer("small", TrainConfig(learning_rate=1e-3, epochs=5,
                                           batch_size=16, augment=False),
                      input_shape=x.shape[1:], device="cpu")
    trainer.fit(x, y)
    loss, acc, probs = trainer.evaluate(x, y)
    assert acc >= 0.9, f"failed to fit separable data: acc={acc}"
    assert probs.shape == (64,) and np.isfinite(loss)
    cm = trainer.confusion_matrix(x, y)
    assert cm.sum() == len(x)
    assert cm[0, 0] + cm[1, 1] >= 0.9 * len(x)
    assert trainer.step == 5 * 4 and len(trainer.history) == 5


def test_frozen_backbone_does_not_move_with_augmentation():
    """freeze_backbone (VGG16, augmentation and dropout on): the backbone
    bit-unchanged and outside the optimizer, the head moved."""
    x = np.random.default_rng(0).uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    y = np.array([0, 1, 0, 1], np.float32)
    trainer = Trainer("vgg16", TrainConfig(freeze_backbone=True, epochs=2,
                                           batch_size=4), input_shape=x.shape[1:],
                      device="cpu", blocks=NARROW)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.fit(x, y)
    after = trainer.model.state_dict()
    for k, v in before.items():
        if k.startswith("backbone."):
            assert torch.equal(v, after[k]), k
            assert not after[k].requires_grad
    assert any(not torch.equal(v, after[k]) for k, v in before.items()
               if k.startswith("head."))
    assert all(p.requires_grad for p in trainer.model.head.parameters())


def test_checkpoint_roundtrip(tmp_path):
    x, y = _toy_dataset(np.random.default_rng(42), n=8, size=16)
    cfg = TrainConfig(epochs=1, batch_size=8, augment=False)
    t1 = Trainer("small", cfg, input_shape=x.shape[1:], device="cpu")
    t1.fit(x, y)
    path = str(tmp_path / "ckpt")
    t1.save(path)
    t2 = Trainer("small", TrainConfig(seed=7), input_shape=x.shape[1:], device="cpu")
    assert not np.array_equal(t1.params["Conv_0"]["kernel"],
                              t2.params["Conv_0"]["kernel"])
    t2.load(path)
    _, _, p1 = t1.evaluate(x, y)
    _, _, p2 = t2.evaluate(x, y)
    np.testing.assert_array_equal(p1, p2)


def test_full_state_resume(tmp_path):
    """save_state/load_state restore params, Adam state, step, both
    generators and history: continued training takes identical steps."""
    x, y = _toy_dataset(np.random.default_rng(42), n=8, size=16)
    cfg = TrainConfig(epochs=1, batch_size=8, augment=True)
    t1 = Trainer("small", cfg, input_shape=x.shape[1:], device="cpu")
    t1.fit(x, y, epochs=2)
    path = str(tmp_path / "state")
    t1.save_state(path)
    t2 = Trainer("small", TrainConfig(epochs=1, batch_size=8, augment=True, seed=9),
                 input_shape=x.shape[1:], device="cpu")
    t2.config = cfg  # the batch order follows the config's seed
    t2.load_state(path)
    assert t2.step == t1.step == 2
    assert t2.history == json.loads(json.dumps(t1.history))
    s1, s2 = t1.optimizer.state_dict()["state"], t2.optimizer.state_dict()["state"]
    for i in s1:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s1[i][k], s2[i][k])
    t1.fit(x, y, epochs=1)
    t2.fit(x, y, epochs=1)
    _, _, p1 = t1.evaluate(x, y)
    _, _, p2 = t2.evaluate(x, y)
    np.testing.assert_array_equal(p1, p2)
    with pytest.raises(FileNotFoundError, match="train state"):
        t2.load_state(str(tmp_path / "missing"))


def test_classification_report():
    x, y = _toy_dataset(np.random.default_rng(42), n=32, size=16)
    t = Trainer("small", TrainConfig(epochs=3, batch_size=8, augment=False),
                input_shape=x.shape[1:], device="cpu")
    t.fit(x, y)
    rep = t.classification_report(x, y, class_names=("calf", "human"))
    assert set(rep) == {"calf", "human", "accuracy"}
    for cls in ("calf", "human"):
        row = rep[cls]
        assert set(row) == {"precision", "recall", "f1", "support"}
        assert 0.0 <= row["f1"] <= 1.0 and row["support"] == 16
    cm = t.confusion_matrix(x, y)
    assert rep["accuracy"] == round(float(np.trace(cm) / cm.sum()), 4)


def test_set_params_takes_a_flax_tree():
    """A Flax-initialized tree set into the Trainer: its logits are Flax's."""
    fmodel, params = _flax("vgg16", seed=4)
    t = Trainer("vgg16", TrainConfig(), input_shape=SHAPE, device="cpu",
                dtype=torch.float32, blocks=NARROW)
    t.set_params(params)
    x = np.random.default_rng(1).uniform(0, 1, (3, *SHAPE)).astype(np.float32)
    want = np.asarray(fmodel.apply({"params": params}, x, train=False))
    with torch.no_grad():
        got = t.model(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    for k, v in _leaves(params).items():
        assert np.array_equal(flatten_tree(t.params)[k], v)


def test_cli_train_export_then_classify(tmp_path, capsys):
    """``train --export`` on the CPU writes the port's artifact, which
    ``classify`` serves; ``--state-dir`` then ``--resume`` continues."""
    from PIL import Image

    x, y = _toy_dataset(np.random.default_rng(5), n=8, size=16)
    for i, (img, label) in enumerate(zip(x, y)):
        d = tmp_path / "data" / ("human" if label else "calf")
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray((img.clip(0, 1) * 255).astype(np.uint8)).resize(
            (32, 32)).save(d / f"{i}.png")
    art, state = str(tmp_path / "art"), str(tmp_path / "state")
    rc = cli_main(["train", "--data-dir", str(tmp_path / "data"), "--epochs", "2",
                   "--batch-size", "4", "--export", art, "--state-dir", state,
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "exported inference artifact" in out
    meta = json.loads((tmp_path / "art" / "meta.json").read_text())
    assert meta["classes"] == ["calf", "human"] and meta["input_shape"] == [224, 224, 3]
    files = sorted(str(p) for p in (tmp_path / "data").rglob("*.png"))[:3]
    assert cli_main(["classify", "--artifact", art, "--device", "cpu", *files]) == 0
    preds = json.loads(capsys.readouterr().out)["predictions"]
    assert [p["file"] for p in preds] == files
    assert all(p["label"] in ("calf", "human") for p in preds)
    assert cli_main(["train", "--data-dir", str(tmp_path / "data"), "--epochs", "1",
                     "--batch-size", "4", "--resume", state, "--device", "cpu"]) == 0
    assert "resumed from" in capsys.readouterr().out
    assert cli_main(["train", "--data-dir", str(tmp_path / "data"), "--resume",
                     str(tmp_path / "none"), "--device", "cpu"]) == 1


def test_params_are_a_snapshot():
    """Trainer.params (state_dict_to_flax) copies every leaf: training on
    does not change a tree taken before, biases included."""
    x, y = _toy_dataset(np.random.default_rng(3), n=8, size=16)
    t = Trainer("small", TrainConfig(epochs=1, batch_size=8, augment=False),
                input_shape=x.shape[1:], device="cpu")
    tree = t.params
    copy = {k: v.copy() for k, v in flatten_tree(tree).items()}
    t.fit(x, y)
    for k, v in flatten_tree(tree).items():
        assert np.array_equal(v, copy[k]), k
    assert not np.array_equal(flatten_tree(t.params)["Dense_1/bias"],
                              copy["Dense_1/bias"])
