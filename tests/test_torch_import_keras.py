"""PyTorch port: the Keras-h5/npz → Flax-layout importer against the JAX
package's ``models/import_keras.py``.

Fabricated Keras-layout weight files (h5 full-model flavor, h5
weights-only flavor, npz schema) for a tiny VGG16 (block1_conv1 with 4
channels, block2_conv1 with 8, 16×16×3 input) go through both importers:
the imported leaves must be equal, the port's model with the imported tree
must reproduce a NumPy forward of the Keras graph, and both must raise the
same errors (missing layers, shape mismatches, ambiguous Dense layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmcw_radar_processing_tpu.models import import_keras as jimp
from fmcw_radar_processing_tpu.models.vgg import VGG16 as FlaxVGG16
from fmcw_radar_processing_tpu_torch.models import import_keras as timp
from fmcw_radar_processing_tpu_torch.models.params import (
    flatten_tree,
    params_from_flax,
    state_dict_to_flax,
)
from fmcw_radar_processing_tpu_torch.models.train import TrainConfig, Trainer
from fmcw_radar_processing_tpu_torch.models.vgg import VGG16, init_flax_default_

h5py = pytest.importorskip("h5py")

TINY_BLOCKS = ((1, 4), (1, 8))
INPUT = (16, 16, 3)  # two pools -> 4*4*8 = 128 flat features
ALL_LEAVES = sorted([
    "backbone/block1_conv1/kernel", "backbone/block1_conv1/bias",
    "backbone/block2_conv1/kernel", "backbone/block2_conv1/bias",
    "head/fc/kernel", "head/fc/bias", "head/out/kernel", "head/out/bias",
])


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: at these sizes it runs as fast as eight, and
    it does not oversubscribe the cores the test workers share (eight
    threads on a loaded machine ran the toy experiment 8× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_model():
    model = VGG16(TINY_BLOCKS, torch.float32, INPUT, device="cpu")
    return init_flax_default_(model, torch.Generator().manual_seed(0))


def _port_template():
    return state_dict_to_flax(_port_model().state_dict())


def _jax_template():
    model = FlaxVGG16(blocks=TINY_BLOCKS, dtype=jnp.float32)
    return model.init(jax.random.PRNGKey(0), jnp.zeros((1, *INPUT)),
                      train=False)["params"]


def _fabricate_weights(rng, with_head=True):
    w = {
        "block1_conv1/kernel": rng.standard_normal((3, 3, 3, 4)).astype("f4"),
        "block1_conv1/bias": rng.standard_normal(4).astype("f4"),
        "block2_conv1/kernel": rng.standard_normal((3, 3, 4, 8)).astype("f4"),
        "block2_conv1/bias": rng.standard_normal(8).astype("f4"),
    }
    if with_head:
        w.update({
            "dense/kernel": rng.standard_normal((128, 256)).astype("f4"),
            "dense/bias": rng.standard_normal(256).astype("f4"),
            "dense_1/kernel": rng.standard_normal((256, 1)).astype("f4"),
            "dense_1/bias": rng.standard_normal(1).astype("f4"),
        })
    return w


def _write_h5(path, weights, full_model=True):
    """Keras's nesting: [model_weights/]<layer>/<layer>/<name>:0."""
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights") if full_model else f
        for key, arr in weights.items():
            layer, name = key.split("/")
            grp = root.require_group(layer).require_group(layer)
            grp.create_dataset(f"{name}:0", data=arr)


def _keras_forward_numpy(weights, x):
    """The Keras graph (conv-relu, maxpool, flatten, dense-relu, dense) in
    NumPy, the independent oracle for the layout."""
    def conv(x, k, b):  # SAME 3x3, NHWC, HWIO
        n, h, wdt, _ = x.shape
        pad = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
        out = np.zeros((n, h, wdt, k.shape[3]), "f4")
        for dy in range(3):
            for dx in range(3):
                out += np.einsum("nhwc,co->nhwo",
                                 pad[:, dy : dy + h, dx : dx + wdt, :], k[dy, dx])
        return np.maximum(out + b, 0.0)

    def pool(x):
        n, h, w_, c = x.shape
        return x.reshape(n, h // 2, 2, w_ // 2, 2, c).max(axis=(2, 4))

    x = pool(conv(x, weights["block1_conv1/kernel"], weights["block1_conv1/bias"]))
    x = pool(conv(x, weights["block2_conv1/kernel"], weights["block2_conv1/bias"]))
    x = x.reshape(x.shape[0], -1)
    x = np.maximum(x @ weights["dense/kernel"] + weights["dense/bias"], 0.0)
    return (x @ weights["dense_1/kernel"] + weights["dense_1/bias"])[:, 0]


@pytest.mark.parametrize("full_model", [True, False])
def test_h5_tree_equals_jax_and_keras_forward(tmp_path, full_model):
    rng = np.random.default_rng(42)
    weights = _fabricate_weights(rng)
    path = str(tmp_path / "model.h5")
    _write_h5(path, weights, full_model=full_model)
    loaded = timp.load_keras_h5(path)
    assert loaded.keys() == jimp.load_keras_h5(path).keys()

    params, imported = timp.import_vgg16_params(_port_template(), loaded)
    jparams, jimported = jimp.import_vgg16_params(_jax_template(), loaded)
    assert sorted(imported) == sorted(jimported) == ALL_LEAVES
    got, want = flatten_tree(params), flatten_tree(jparams)
    assert got.keys() == want.keys()
    for k in want:  # every leaf imported: the trees are equal
        assert np.array_equal(got[k], np.asarray(want[k])), k
        assert got[k].dtype == np.float32

    model = VGG16(TINY_BLOCKS, torch.float32, INPUT, device="cpu")
    model.load_state_dict(params_from_flax("vgg16", params, INPUT, blocks=TINY_BLOCKS))
    x = rng.standard_normal((2, *INPUT)).astype("f4")
    with torch.no_grad():
        logits = model(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(logits, _keras_forward_numpy(weights, x),
                               rtol=1e-4, atol=1e-4)


def test_npz_backbone_only_keeps_template_head(tmp_path):
    weights = _fabricate_weights(np.random.default_rng(42), with_head=False)
    path = str(tmp_path / "backbone.npz")
    np.savez(path, **weights)
    template = _port_template()
    params, imported = timp.import_vgg16_params(template, timp.load_npz_weights(path))
    _, jimported = jimp.import_vgg16_params(_jax_template(), jimp.load_npz_weights(path))
    assert sorted(imported) == sorted(jimported) and len(imported) == 4
    assert all(p.startswith("backbone/") for p in imported)
    np.testing.assert_array_equal(params["head"]["fc"]["kernel"],
                                  template["head"]["fc"]["kernel"])
    np.testing.assert_array_equal(params["backbone"]["block1_conv1"]["kernel"],
                                  weights["block1_conv1/kernel"])
    assert not np.array_equal(template["backbone"]["block1_conv1"]["kernel"],
                              weights["block1_conv1/kernel"])  # template kept


def test_strict_missing_layer_raises_as_jax(tmp_path):
    weights = _fabricate_weights(np.random.default_rng(42))
    del weights["block2_conv1/kernel"], weights["block2_conv1/bias"]
    path = str(tmp_path / "partial.h5")
    _write_h5(path, weights)
    for imp, template in ((timp, _port_template()), (jimp, _jax_template())):
        with pytest.raises(KeyError, match="block2_conv1"):
            imp.import_vgg16_params(template, imp.load_keras_h5(path))
        _, imported = imp.import_vgg16_params(template, imp.load_keras_h5(path),
                                              strict=False)
        assert "backbone/block1_conv1/kernel" in imported
        assert "backbone/block2_conv1/kernel" not in imported


def test_shape_mismatch_raises_as_jax(tmp_path):
    weights = _fabricate_weights(np.random.default_rng(42))
    weights["block1_conv1/kernel"] = weights["block1_conv1/kernel"][:, :, :, :2]
    path = str(tmp_path / "bad.h5")
    _write_h5(path, weights)
    for imp, template in ((timp, _port_template()), (jimp, _jax_template())):
        with pytest.raises(ValueError, match="shape mismatch"):
            imp.import_vgg16_params(template, imp.load_keras_h5(path))


def test_ambiguous_dense_raises_as_jax():
    w = _fabricate_weights(np.random.default_rng(42))
    w["dense_2/kernel"] = np.zeros((128, 256), "f4")
    w["dense_2/bias"] = np.zeros(256, "f4")
    for imp, template in ((timp, _port_template()), (jimp, _jax_template())):
        with pytest.raises(ValueError, match="ambiguous"):
            imp.import_vgg16_params(template, w)


def test_load_pretrained_into_trainer(tmp_path):
    """Imported params drop into Trainer with freeze_backbone — the
    transfer-learning setup of notebook cell 19: after training the
    backbone still holds the imported values."""
    rng = np.random.default_rng(42)
    weights = _fabricate_weights(rng, with_head=False)
    path = str(tmp_path / "imagenet_tiny.npz")
    np.savez(path, **weights)
    params, imported = timp.load_pretrained_vgg16(path, _port_model(), input_shape=INPUT)
    assert len(imported) == 4
    trainer = Trainer("vgg16", TrainConfig(freeze_backbone=True, epochs=1, batch_size=4),
                      input_shape=INPUT, device="cpu", dtype=torch.float32,
                      blocks=TINY_BLOCKS)
    trainer.set_params(params)
    x = rng.uniform(0, 1, (4, *INPUT)).astype("f4")
    trainer.fit(x, np.array([0, 1, 0, 1], "f4"))
    np.testing.assert_array_equal(
        trainer.params["backbone"]["block1_conv1"]["kernel"],
        weights["block1_conv1/kernel"])
    assert not np.array_equal(trainer.params["head"]["fc"]["kernel"],
                              params["head"]["fc"]["kernel"])


def test_load_pretrained_default_template(tmp_path):
    """Without a model the template is a full-width VGG16 for input_shape
    (here 32×32): the tiny file's convs are refused for their widths."""
    weights = _fabricate_weights(np.random.default_rng(1), with_head=False)
    path = str(tmp_path / "tiny.npz")
    np.savez(path, **weights)
    with pytest.raises(ValueError, match="shape mismatch.*model wants \\(3, 3, 3, 64\\)"):
        timp.load_pretrained_vgg16(path, input_shape=(32, 32, 3))
