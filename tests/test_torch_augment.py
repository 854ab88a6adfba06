"""PyTorch port: the classifier's data pipeline against the JAX package's
``models/data.py`` — the dataset splits (the same file lists for a seed),
the affine composition, the bilinear warp with Keras' "nearest" fill, and
the seeded batch augmentation — and train-mode dropout with Flax's
semantics.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fmcw_radar_processing_tpu.models import data as jdata
from fmcw_radar_processing_tpu_torch.models import data as tdata
from fmcw_radar_processing_tpu_torch.models.vgg import SmallCNN, _dropout

WARP_ATOL = 1e-5  # float32 bilinear blend of values in [0, 1]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: at these sizes it runs as fast as eight, and
    it does not oversubscribe the cores the test workers share (eight
    threads on a loaded machine ran the toy experiment 8× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(n=4, h=24, w=20, c=3, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, h, w, c)).astype(np.float32)


def _jax_draws(key, n, h, w, rotation_deg=20.0, shift=0.2, shear=0.2, zoom=0.2):
    """The seven draws of the JAX package's augment_batch for ``key``, in
    its own order (data.py:193-206)."""
    k_rot, k_sy, k_sx, k_shear, k_zy, k_zx, k_flip = jax.random.split(key, 7)
    u = jax.random.uniform
    theta = jnp.deg2rad(u(k_rot, (n,), minval=-rotation_deg, maxval=rotation_deg))
    ty = u(k_sy, (n,), minval=-shift, maxval=shift) * h
    tx = u(k_sx, (n,), minval=-shift, maxval=shift) * w
    shear_r = u(k_shear, (n,), minval=-shear, maxval=shear)
    zy = u(k_zy, (n,), minval=1 - zoom, maxval=1 + zoom)
    zx = u(k_zx, (n,), minval=1 - zoom, maxval=1 + zoom)
    flip = jax.random.bernoulli(k_flip, 0.5, (n,)).astype(jnp.float32) * -2.0 + 1.0
    return [np.array(a, np.float32) for a in (theta, ty, tx, shear_r, zy, zx, flip)]


# --- splits -------------------------------------------------------------------


@pytest.mark.parametrize("n,seed", [(100, 42), (37, 7), (3, 0)])
def test_split_dataset_same_lists_as_jax(n, seed):
    items = [f"img{i}.png" for i in range(n)]
    assert tdata.split_dataset(items, seed=seed) == jdata.split_dataset(items, seed=seed)


def test_split_combined_folders_same_files_as_jax(tmp_path):
    """Cell 12's merged <class> and <class>_2 trees: the same merged names in
    the same splits as JAX, each copied once, stale trees removed."""
    for folder, n in (("human", 10), ("human_2", 10), ("calf", 20)):
        d = tmp_path / "src" / folder
        d.mkdir(parents=True)
        for i in range(n):
            (d / f"img{i}.png").write_bytes(b"png" + bytes([i]))
        (d / "notes.txt").write_text("not an image")
    sources = {"human": [str(tmp_path / "src/human"), str(tmp_path / "src/human_2")],
               "calf": [str(tmp_path / "src/calf")]}
    stale = tmp_path / "t" / "train" / "calf" / "stale.png"
    stale.parent.mkdir(parents=True)
    stale.write_bytes(b"old")
    got = tdata.split_dataset_combined_folders(sources, str(tmp_path / "t"), seed=3)
    want = jdata.split_dataset_combined_folders(sources, str(tmp_path / "j"), seed=3)
    assert not stale.exists()
    for split in ("train", "val", "test"):
        for cname in ("human", "calf"):
            names = [os.path.basename(p) for p in got[split][cname]]
            assert names == [os.path.basename(p) for p in want[split][cname]]
            assert sorted(os.listdir(tmp_path / "t" / split / cname)) == sorted(names)
    assert [len(got[s]["human"]) for s in ("train", "val", "test")] == [14, 3, 3]
    assert tdata.merge_class_folders(sources["human"]) == \
        jdata.merge_class_folders(sources["human"])


# --- affine composition and warp ------------------------------------------------


def test_augment_batch_matches_jax_on_its_draws():
    """JAX's augment_batch for a key against the port's affine_matrices +
    warp on the same seven draws: the composition (flip scaling all of row
    1, the x shift included) and the warp together, atol 1e-5."""
    x = _images(6, 32, 28)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jdata.augment_batch(key, jnp.asarray(x)))
    draws = [torch.as_tensor(a) for a in _jax_draws(key, 6, 32, 28)]
    assert set(draws[-1].tolist()) == {-1.0, 1.0}  # both flips occur
    got = tdata.warp(torch.as_tensor(x), tdata.affine_matrices(*draws)).numpy()
    np.testing.assert_allclose(got, want, atol=WARP_ATOL, rtol=0)


def test_affine_matrices_compose_as_keras():
    """The composition written out element by element (JAX data.py:207-220)."""
    rng = np.random.default_rng(1)
    d = [rng.uniform(-0.5, 0.5, 5).astype(np.float32) for _ in range(4)]
    zy, zx = rng.uniform(0.8, 1.2, (2, 5)).astype(np.float32)
    flip = np.array([1, -1, 1, -1, -1], np.float32)
    theta, ty, tx, shear = d
    m = tdata.affine_matrices(*(torch.as_tensor(a) for a in
                                (theta, ty, tx, shear, zy, zx, flip))).numpy()
    c, s = np.cos(theta), np.sin(theta)
    np.testing.assert_allclose(m[:, 0], np.stack([c / zy, s / zy, ty], -1), rtol=1e-6)
    np.testing.assert_allclose(
        m[:, 1], np.stack([(-s + shear * c) / zx * flip, (c + shear * s) / zx * flip,
                           tx * flip], -1), rtol=1e-6, atol=1e-7)


def _mats(rows):
    return torch.as_tensor(np.asarray(rows, np.float32))


@pytest.mark.parametrize("name,mat", [
    ("flip", [[1, 0, 0], [0, -1, 0]]),
    ("zoom_in", [[0.8, 0, 0], [0, 0.8, 0]]),
    ("zoom_out_clamped", [[1.25, 0, 0], [0, 1.3, 0]]),
    ("shift_past_edge", [[1, 0, 7.5], [0, 1, -30.0]]),
    ("rotate_shear", [[0.94, 0.34, 1.5], [-0.2, 1.1, -2.25]]),
])
def test_warp_matches_jax_warp_one(name, mat):
    """warp against jax.vmap(_warp_one) on the same matrix, including flips,
    zooms and shifts past the edge (Keras' nearest fill), atol 1e-5."""
    x = _images(2, 24, 20)
    mats = np.asarray([mat, mat], np.float32)
    want = np.asarray(jax.vmap(jdata._warp_one)(jnp.asarray(x), jnp.asarray(mats)))
    got = tdata.warp(torch.as_tensor(x), _mats(mats)).numpy()
    np.testing.assert_allclose(got, want, atol=WARP_ATOL, rtol=0)


def test_warp_identity_and_flip_are_exact():
    x = _images(3, 16, 10)
    eye = _mats([[[1, 0, 0], [0, 1, 0]]] * 3)
    assert np.array_equal(tdata.warp(torch.as_tensor(x), eye).numpy(), x)
    flip = _mats([[[1, 0, 0], [0, -1, 0]]] * 3)
    assert np.array_equal(tdata.warp(torch.as_tensor(x), flip).numpy(), x[:, :, ::-1])


def test_augment_batch_seeded_shape_range():
    """The JAX test's properties on the port: shape and range kept,
    different draws for different generator states, the same for one
    seed; without flips no matrix mirrors x."""
    x = torch.as_tensor(_images(4, 32, 32))
    a = tdata.augment_batch(torch.Generator().manual_seed(1), x)
    b = tdata.augment_batch(torch.Generator().manual_seed(1), x)
    c = tdata.augment_batch(torch.Generator().manual_seed(2), x)
    assert a.shape == x.shape and a.dtype == torch.float32
    assert float(a.min()) >= -1e-5 and float(a.max()) <= 1.0 + 1e-5
    assert torch.equal(a, b)
    assert float((a - c).abs().max()) > 1e-3
    gen = torch.Generator().manual_seed(5)
    ident = tdata.augment_batch(gen, x, rotation_deg=0.0, shift=0.0, shear=0.0,
                                zoom=0.0, horizontal_flip=False)
    assert np.array_equal(ident.numpy(), x.numpy())


# --- dropout --------------------------------------------------------------------


def test_dropout_has_flax_semantics():
    """Kept values scaled by 1/(1−p), the rest 0, the mask from the
    caller's generator; off (the identity) without train or at rate 0."""
    x = torch.rand(64, 256, generator=torch.Generator().manual_seed(0)) + 0.5
    out = _dropout(x, 0.5, True, torch.Generator().manual_seed(9))
    kept = out != 0
    assert torch.equal(out[kept], x[kept] * 2.0)
    assert 0.45 < float(kept.float().mean()) < 0.55
    again = _dropout(x, 0.5, True, torch.Generator().manual_seed(9))
    assert torch.equal(out, again)
    assert _dropout(x, 0.5, False, None) is x
    assert _dropout(x, 0.0, True, torch.Generator()) is x


def test_model_forward_unchanged_without_train():
    """The default forward (inference) is the train=False forward, bit for
    bit; train=True draws a mask from the generator."""
    model = SmallCNN(dtype=torch.float32, input_shape=(16, 16, 3), device="cpu")
    x = torch.as_tensor(_images(5, 16, 16))
    with torch.no_grad():
        a = model(x)
        b = model(x, train=False)
        t1 = model(x, train=True, generator=torch.Generator().manual_seed(4))
        t2 = model(x, train=True, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and torch.equal(t1, t2)
    assert not torch.equal(a, t1)
