"""PyTorch port: the chain-generated micro-Doppler dataset against the JAX
package's ``models/dataset_gen.py``.

The same seed must give the same scenes (``ClassSpec.sample`` draws with
NumPy only) and the same images up to the chain's rounding: every
spectrogram PNG within 2 of 255 levels of JAX's in every channel and at
most 0.1% of its values different (measured: at most 1 level, on under
0.01% of values). Then the JAX tests' own checks: the layout, no
degenerate image, and classes more different across than within
(``test_experiment.py:28-57``), for calf/human and calf/bees.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from fmcw_radar_processing_tpu.models import dataset_gen as jgen
from fmcw_radar_processing_tpu_torch.models import dataset_gen as tgen

PIXEL_LEVELS = 2  # of 255, per channel
PIXEL_SHARE = 1e-3  # of values allowed to differ at all


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: at these sizes it runs as fast as eight, and
    it does not oversubscribe the cores the test workers share (eight
    threads on a loaded machine ran the toy experiment 8× slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pngs(paths):
    return [np.asarray(Image.open(p), float) / 255.0 for p in paths]


def test_class_specs_and_scenes_equal_jax():
    """The class specs field for field, and the scenes a seed draws."""
    assert set(tgen.CLASS_SPECS) == set(jgen.CLASS_SPECS) == {"human", "calf", "bees"}
    for name, spec in tgen.CLASS_SPECS.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(jgen.CLASS_SPECS[name])
    assert [c.name for c in tgen.DEFAULT_CLASSES] == [c.name for c in jgen.DEFAULT_CLASSES]
    rt, rj = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(20):
        for name in ("human", "calf", "bees"):
            got = tgen.CLASS_SPECS[name].sample(rt)
            want = jgen.CLASS_SPECS[name].sample(rj)
            assert [dataclasses.asdict(t) for t in got] == \
                [dataclasses.asdict(t) for t in want]


@pytest.mark.parametrize("mixture_frac", [0.0, 1.0])
def test_images_match_jax(tmp_path, mixture_frac):
    """3 images a class, 48 frames, 160×120, seed 7 (with distractors at
    mixture_frac 1): the same file names, pixels within the stated
    tolerance of JAX's."""
    kw = dict(images_per_class=3, frames_per_recording=48, image_size=(160, 120),
              seed=7, mixture_frac=mixture_frac)
    got = tgen.generate_micro_doppler_dataset(str(tmp_path / "t"), device="cpu", **kw)
    want = jgen.generate_micro_doppler_dataset(str(tmp_path / "j"), **kw)
    assert list(got) == list(want) == ["calf", "human"]
    for cname in want:
        assert [p.split("/")[-1] for p in got[cname]] == \
            [p.split("/")[-1] for p in want[cname]]
        for a, b in zip(_pngs(got[cname]), _pngs(want[cname])):
            d = np.abs(a - b) * 255.0
            assert a.shape == b.shape == (120, 160, 3)
            assert d.max() <= PIXEL_LEVELS + 1e-9
            assert float((d > 0.5).mean()) <= PIXEL_SHARE


@pytest.mark.parametrize("classes,seed", [
    ((tgen.CALF, tgen.HUMAN), 7),
    ((tgen.CALF, tgen.BEES), 11),
])
def test_generated_classes_differ(tmp_path, classes, seed):
    """Chain-generated spectrogram images: right layout, no degenerate
    image, classes separable (cross-class distance above within-class)."""
    res = tgen.generate_micro_doppler_dataset(
        str(tmp_path), classes, images_per_class=3, frames_per_recording=48,
        image_size=(160, 120), seed=seed, device="cpu")
    names = [c.name for c in classes]
    assert list(res) == names
    arrs = {c: _pngs(ps) for c, ps in res.items()}
    for c, imgs in arrs.items():
        for a in imgs:
            assert a.shape == (120, 160, 3)
            assert a.std() > 0.01, f"degenerate {c} image"
    cross = np.mean([np.abs(x - y).mean()
                     for x in arrs[names[0]] for y in arrs[names[1]]])
    within = np.mean([np.abs(x - y).mean()
                      for c in arrs for x in arrs[c] for y in arrs[c] if x is not y])
    assert cross > within, (cross, within)
