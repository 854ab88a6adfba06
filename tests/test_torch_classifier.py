"""PyTorch port: classifier inference vs the JAX package's Flax models.

Flax-initialized parameters of a narrow VGG16 (blocks (1, 8), (1, 16)) and
of SmallCNN, both at 32×32×3, are carried into the port's modules by
``params_from_flax``; the logits must match Flax's in float32 and in
bfloat16. Then the artifact, the bucketed batching, the image decode and
the classify schema are held to the JAX inference module.
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmcw_radar_processing_tpu.models.data import load_image as jax_load_image
from fmcw_radar_processing_tpu.models.data import (
    load_image_folder as jax_load_image_folder,
)
from fmcw_radar_processing_tpu.models.infer import (
    SpectrogramClassifier as JaxClassifier,
)
from fmcw_radar_processing_tpu.models.vgg import VGG16 as FlaxVGG16
from fmcw_radar_processing_tpu.models.vgg import SmallCNN as FlaxSmallCNN
from fmcw_radar_processing_tpu_torch.models.data import load_image, load_image_folder
from fmcw_radar_processing_tpu_torch.models.infer import (
    MAX_BATCH_BUCKET,
    SpectrogramClassifier,
    _bucket,
    export_classifier,
)
from fmcw_radar_processing_tpu_torch.models.params import (
    params_from_flax,
    state_dict_to_flax,
)
from fmcw_radar_processing_tpu_torch.models.vgg import build_model

SHAPE = (32, 32, 3)
CLASSES = ("calf", "human")
NARROW = ((1, 8), (1, 16))
MODELS = {
    "vgg16": (FlaxVGG16, {"blocks": NARROW}),
    "small": (FlaxSmallCNN, {}),
}


def _flax_params(name, seed=1):
    cls, kw = MODELS[name]
    model = cls(**kw)
    return model.init(jax.random.PRNGKey(seed), jnp.zeros((1, *SHAPE)),
                      train=False)["params"]


def _images(n, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, *SHAPE)).astype(np.float32)


def _png_bytes(img01: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray((img01 * 255).astype(np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_flax(name, dtype):
    """float32: rtol 1e-4 / atol 1e-5. bfloat16: within 3e-2·max|logit|
    with the same labels wherever |logit| > 0.1 (measured: 3e-8, the two
    frameworks round to bf16 at the same places)."""
    cls, kw = MODELS[name]
    params = _flax_params(name)
    x = _images(6)
    want = np.asarray(cls(dtype=getattr(jnp, dtype), **kw).apply(
        {"params": params}, x, train=False), np.float32)
    model = build_model(name, SHAPE, dtype=getattr(torch, dtype), **kw)
    model.load_state_dict(params_from_flax(name, params, SHAPE, **kw))
    with torch.no_grad():
        got = model(torch.as_tensor(x)).float().numpy()
    assert got.shape == want.shape == (6,)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()
        sure = np.abs(want) > 0.1
        np.testing.assert_array_equal((got > 0)[sure], (want > 0)[sure])


def _leaves_case(params, case):
    tree = jax.tree_util.tree_map(np.asarray, params)
    tree = {k: dict(v) if isinstance(v, dict) else v for k, v in tree.items()}
    if case == "missing":
        del tree["Conv_2"]["bias"]
    elif case == "extra":
        tree["Dense_2"] = {"kernel": np.zeros((128, 1), np.float32)}
    elif case == "renamed":
        tree["Conv_0"]["scale"] = tree["Conv_0"].pop("bias")
    else:  # wrongly shaped: half a dense kernel
        tree["Dense_0"]["kernel"] = tree["Dense_0"]["kernel"][:, :64]
    return tree


@pytest.mark.parametrize("case", ["missing", "extra", "renamed", "shape"])
def test_params_from_flax_rejects_bad_trees(case):
    tree = _leaves_case(_flax_params("small"), case)
    with pytest.raises(ValueError):
        params_from_flax("small", tree, SHAPE)


def test_params_round_trip_and_vgg_head_shape():
    params = _flax_params("vgg16")
    sd = params_from_flax("vgg16", params, SHAPE, blocks=NARROW)
    assert tuple(sd["head.fc.weight"].shape) == (256, 8 * 8 * 16)
    back = state_dict_to_flax(sd)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    with pytest.raises(ValueError):  # the default VGG16 blocks do not fit
        params_from_flax("vgg16", params, SHAPE)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clf") / "artifact")
    params = _flax_params("small", seed=3)
    export_classifier(path, "small", params, SHAPE, CLASSES)
    return path, params


def test_artifact_round_trip(artifact):
    path, params = artifact
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta == {"model": "small", "input_shape": list(SHAPE),
                    "classes": list(CLASSES), "normalization": "1/255"}
    clf = SpectrogramClassifier.load(path)
    assert clf.classes == CLASSES and clf.input_shape == SHAPE
    x = _images(7, seed=5)
    direct = SpectrogramClassifier("small", params, SHAPE, CLASSES)
    np.testing.assert_array_equal(clf.predict_proba(x), direct.predict_proba(x))
    # And the JAX classifier on the same parameters (bf16 forward).
    want = JaxClassifier("small", params, SHAPE, CLASSES).predict_proba(x)
    np.testing.assert_allclose(clf.predict_proba(x), want, rtol=0, atol=1e-3)


def test_export_rejects_bad_arguments(tmp_path):
    params = _flax_params("small")
    with pytest.raises(ValueError, match="unknown model"):
        export_classifier(str(tmp_path / "a"), "resnet", params, SHAPE, CLASSES)
    with pytest.raises(ValueError, match="2 classes"):
        export_classifier(str(tmp_path / "b"), "small", params, SHAPE, ("a",))
    with pytest.raises(ValueError):
        export_classifier(str(tmp_path / "c"), "vgg16", params, SHAPE, CLASSES)
    assert not os.path.exists(tmp_path / "c" / "meta.json")


def test_bucketed_batching(artifact):
    """1, 5 and 67 images (buckets 1 and 8; chunks of 64 + 3 in bucket 4)
    give the same per-image results: bf16 convolutions may sum in another
    order at another batch size, hence 5e-4 (the JAX test's bound)."""
    path, _ = artifact
    clf = SpectrogramClassifier.load(path)
    assert [_bucket(n) for n in (1, 3, 5, 64, 67)] == [1, 4, 8, 64, 64]
    x = _images(67, seed=9)
    big = clf.predict_proba(x)
    assert big.shape == (67,) and MAX_BATCH_BUCKET == 64
    np.testing.assert_allclose(clf.predict_proba(x[:1]), big[:1], rtol=0, atol=5e-4)
    np.testing.assert_allclose(clf.predict_proba(x[:5]), big[:5], rtol=0, atol=5e-4)
    np.testing.assert_allclose(clf.predict_proba(x[64:]), big[64:], rtol=0,
                               atol=5e-4)
    np.testing.assert_array_equal(clf.predict_proba(x[0]), clf.predict_proba(x[:1]))


def test_shape_mismatch_and_missing_artifact(artifact, tmp_path):
    clf = SpectrogramClassifier.load(artifact[0])
    with pytest.raises(ValueError, match="expected images of shape"):
        clf.predict_proba(np.zeros((1, 8, 8, 3), np.float32))
    with pytest.raises(FileNotFoundError, match="not a classifier artifact"):
        SpectrogramClassifier.load(str(tmp_path / "nope"))


def test_decode_and_schema_match_jax(artifact):
    path, params = artifact
    clf = SpectrogramClassifier.load(path)
    ref = JaxClassifier("small", params, SHAPE, CLASSES)
    img = np.random.default_rng(1).uniform(0, 1, (40, 52, 3))
    blob = _png_bytes(img)
    got = clf.decode_image_bytes(blob)
    assert got.shape == SHAPE and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref.decode_image_bytes(blob))
    two = clf.classify_bytes([blob, blob])
    assert len(two) == 2 and two[0] == two[1] and two[0]["label"] in CLASSES
    probs = np.array([0.0, 0.25, 0.5, 0.5000001, 0.73, 1.0], np.float32)
    clf.predict_proba = lambda images: probs
    ref.predict_proba = lambda images: probs
    assert clf.classify(np.zeros((6, *SHAPE))) == ref.classify(np.zeros((6, *SHAPE)))


def test_image_loaders_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    for cname, n in (("human", 2), ("calf", 1)):
        (tmp_path / cname).mkdir()
        for i in range(n):
            (tmp_path / cname / f"{i}.png").write_bytes(
                _png_bytes(rng.uniform(0, 1, (20 + i, 30, 3))))
    (tmp_path / "calf" / "notes.txt").write_text("skip me")
    got = load_image_folder(str(tmp_path), size=(16, 16))
    want = jax_load_image_folder(str(tmp_path), size=(16, 16))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == ["calf", "human"]
    one = str(tmp_path / "human" / "1.png")
    np.testing.assert_array_equal(load_image(one), jax_load_image(one))
    with pytest.raises(ValueError, match="no images"):
        load_image_folder(str(tmp_path / "calf"))  # no class folders
