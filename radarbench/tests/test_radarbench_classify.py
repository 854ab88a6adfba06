"""The classifier cell on the CPU at a tiny size (32×32×3 images, every
width as published, 2 clients × 2 images): the images and the fitted
readout, the reference against the port's VGG16 in float32, the
least-work count at 224, and faults planted in the timed path that
``correct`` has to see. (The reference imports nothing of the port; these
tests do, to hold the two to each other.)"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from radarbench import harness, roofline
from radarbench.drivers.classify import decode_png
from radarbench.gen import spectrograms, synth, weights
from radarbench.reference import vgg16 as ref_vgg
from radarbench.tests.conftest import REPO

CELL = "vgg16-224.classify"
CFG = json.loads((REPO / "radarbench" / "configs" / "vgg16-224.json").read_text())
IMAGES = json.loads((REPO / "radarbench" / "traffic" / "classify.json").read_text())["images"]
SEED = 2**31 + 4321
SHAPE = (32, 32, 3)


def _pool(seed: int, n: int = 16) -> tuple[np.ndarray, dict]:
    """``n`` images of the generator as the service decodes them, and
    seeded weights with the last Dense fitted to them, at 32×32."""
    pngs, _ = spectrograms.spectrogram_pngs(n, SHAPE[:2], IMAGES, seed)
    x = np.stack([decode_png(p, SHAPE) for p in pngs])
    params = weights.vgg_params(CFG["blocks"], SHAPE, CFG["head"], CFG["bias_std"],
                                synth.generator(seed, "cpu"), "cpu")
    feats = ref_vgg.Vgg16Ref(params, CFG["blocks"], "cpu").features(x)
    params["head/out/kernel"], params["head/out/bias"] = weights.fit_readout(
        feats, CFG["logit_std"])
    return x, params


def test_spectrograms_draw_from_the_seed_in_equal_classes():
    one, labels = spectrograms.spectrogram_pngs(8, (48, 40), IMAGES, SEED)
    two, _ = spectrograms.spectrogram_pngs(8, (48, 40), IMAGES, SEED)
    other, _ = spectrograms.spectrogram_pngs(8, (48, 40), IMAGES, SEED + 1)
    assert one == two and one != other and len(set(one)) == 8
    assert sorted(labels) == ["calf"] * 4 + ["human"] * 4
    x = decode_png(one[0], (48, 40, 3))
    assert x.shape == (48, 40, 3) and 0.0 <= x.min() < x.max() <= 1.0
    assert spectrograms.jet(np.array([0.0, 0.5, 1.0])).tolist() == [
        [0, 0, 128], [128, 255, 128], [128, 0, 0]]  # MATLAB's jet at its ends and middle
    with pytest.raises(ValueError):
        spectrograms.spectrogram_pngs(7, (48, 40), IMAGES, SEED)


def test_the_fitted_readout_spreads_the_pool_apart():
    """The pool's logits come out centred on 0 with the configured
    spread, and every two images' logits lie apart by more than the
    program's bf16 gap could reach: an answer given to another image
    shows."""
    x, params = _pool(SEED)
    logits = ref_vgg.Vgg16Ref(params, CFG["blocks"], "cpu").logits(x)
    assert np.std(logits) == pytest.approx(CFG["logit_std"], rel=1e-4)
    assert abs(np.mean(logits)) < 1e-4 and (logits > 0).any() and (logits < 0).any()
    k, b = params["head/out/kernel"], params["head/out/bias"]
    assert k.shape == (CFG["head"], 1) and k.dtype == b.dtype == np.float32
    again = weights.fit_readout(ref_vgg.Vgg16Ref(params, CFG["blocks"], "cpu").features(x),
                                CFG["logit_std"])
    assert np.array_equal(again[0], k) and np.array_equal(again[1], b)
    gaps = np.abs(logits[:, None] - logits[None, :])[np.triu_indices(len(x), 1)]
    assert np.median(gaps) > 0.5 * CFG["logit_std"]


def test_vgg16_work_at_224_is_30_706_gflop_and_compute_bound():
    w = roofline.vgg16_work((224, 224, 3), CFG["blocks"], CFG["head"], 1)
    assert w["flops"] == 30_706_106_880  # 2 × 15.353 G multiply-adds
    assert roofline.least_seconds(w["bytes"], w["flops"], w["flop_peak"])[1] == "operations"
    two = roofline.vgg16_work((224, 224, 3), CFG["blocks"], CFG["head"], 2, forwards=1)
    assert two["flops"] == 2 * w["flops"] and two["bytes"] < 2 * w["bytes"]


def test_weights_draw_from_the_seed_in_the_port_layout():
    from fmcw_radar_processing_tpu_torch.models.params import params_from_flax, unflatten_tree

    shape = (32, 32, 3)
    one, two = (weights.vgg_params(CFG["blocks"], shape, CFG["head"], CFG["bias_std"],
                                   synth.generator(SEED, "cpu"), "cpu") for _ in range(2))
    assert all(np.array_equal(one[k], two[k]) for k in one)
    params_from_flax("vgg16", unflatten_tree(one), shape)  # every leaf, every shape
    k = one["backbone/block3_conv2/kernel"]
    assert abs(k.std() * np.sqrt(9 * 256) - 1.0) < 0.05 and np.abs(k).max() <= 2.0 / np.sqrt(
        9 * 256) / weights.TRUNC_STD + 1e-6
    k8 = ref_vgg.fp8_round(torch.from_numpy(k)).numpy()
    assert np.abs(k8).max() == pytest.approx(np.abs(k).max(), rel=1e-6)
    assert 0 < np.abs(k8 - k).max() / np.abs(k).max() <= 2.0**-4


def test_reference_agrees_with_the_port_vgg16_in_float32():
    from fmcw_radar_processing_tpu_torch.models.params import params_from_flax, unflatten_tree
    from fmcw_radar_processing_tpu_torch.models.vgg import VGG16, VGG16_BLOCKS

    assert [tuple(b) for b in CFG["blocks"]] == list(VGG16_BLOCKS)
    x, params = _pool(SEED, 6)
    port = VGG16(dtype=torch.float32, input_shape=SHAPE, device="cpu").eval()
    port.load_state_dict(params_from_flax("vgg16", unflatten_tree(params), SHAPE))
    with torch.inference_mode():
        want = port(torch.from_numpy(x)).double().numpy()
    got = ref_vgg.Vgg16Ref(params, CFG["blocks"], "cpu").logits(x)
    assert np.abs(got - want).max() <= 1e-4 * np.std(want)
    fp8 = ref_vgg.Vgg16Ref(params, CFG["blocks"], "cpu", fp8=True)
    assert np.abs(fp8(torch.from_numpy(x)).double().numpy() - want).max() > 0.1 * np.std(want)


def test_check_answers_reads_gaps_and_faults():
    logits = np.array([0.3, -0.2])  # standard deviation 0.25

    def pred(s):
        idx = int(s > 0.5)
        return {"label": ("calf", "human")[idx], "class_index": idx,
                "probability": round(s if idx else 1 - s, 6), "score": round(s, 6)}

    ok = [pred(1 / (1 + np.exp(-v))) for v in logits]
    good = (0, 200, {"status": "success", "classes": ["calf", "human"], "predictions": ok})
    r = ref_vgg.check_answers([good], ("calf", "human"), logits, 2)
    assert r["response_faults"] == 0 and r["logit_err"] <= ref_vgg.score_quantum(logits) / 0.25
    off = dict(good[2], predictions=[pred(1 / (1 + np.exp(-0.5))), ok[1]])
    r = ref_vgg.check_answers([(0, 200, off)], ("calf", "human"), logits, 2)
    assert r["logit_err"] == pytest.approx(0.2 / 0.25, rel=1e-4)
    bad_label = dict(good[2], predictions=[dict(ok[0], label="calf"), ok[1]])
    for answer in [(0, 503, {"status": "error"}), (0, 200, bad_label),
                   (0, 200, dict(good[2], predictions=ok[:1]))]:
        assert ref_vgg.check_answers([answer], ("calf", "human"), logits,
                                     2)["response_faults"] == 1


def _classifier():
    from fmcw_radar_processing_tpu_torch.models.infer import SpectrogramClassifier

    return SpectrogramClassifier


def test_a_served_score_altered_fails(tiny_root, monkeypatch):
    """One image's probability moved where it is made, its label and
    score kept consistent with it."""
    clf = _classifier()
    orig = clf.predict_proba

    def altered(self, images):
        p = orig(self, images)
        p[0] = min(p[0] + 0.25, 0.999)
        return p

    monkeypatch.setattr(clf, "predict_proba", altered)
    r = harness.run_cell(tiny_root, CELL, SEED, 0.2, False, "cpu")
    assert not r["correct"] and r["checks"]["response_faults"]["value"] == 0
    assert r["checks"]["logit_err"]["value"] > r["checks"]["logit_err"]["limit"]


def test_half_of_the_batch_left_out_fails(tiny_root, monkeypatch):
    """The forward runs on the first half of each bucket; the second half's
    rows keep a logit of nought (probability 0.5)."""
    _leave_half_out(monkeypatch)
    r = harness.run_cell(tiny_root, CELL, SEED, 0.2, False, "cpu")
    assert not r["correct"], r["checks"]


def test_results_handed_out_in_the_wrong_order_by_the_classifier_fails(tiny_root, monkeypatch):
    """The classifier hands a batch's answers out in reverse order, so that
    an image gets the answer of another image of its request, or of
    another request of its batch."""
    clf = _classifier()
    orig = clf.classify
    monkeypatch.setattr(clf, "classify", lambda self, images: orig(self, images)[::-1])
    r = harness.run_cell(tiny_root, CELL, SEED, 0.2, False, "cpu")
    assert not r["correct"], r["checks"]


def test_two_requests_results_swapped_by_the_batcher_fails(tiny_root, monkeypatch):
    """The batcher hands the first two requests of a coalesced batch each
    other's answers. Four clients, so that requests coalesce; the test
    counts the swaps of two different bodies, so that it cannot pass on
    swaps that change nothing."""
    path = tiny_root / "radarbench" / "traffic" / "classify.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), client_threads=4)))
    swapped = _swap_two_requests(monkeypatch)
    r = harness.run_cell(tiny_root, CELL, SEED, 0.5, False, "cpu")
    assert any(swapped), swapped
    assert not r["correct"] and r["checks"]["response_faults"]["value"] == 0, r["checks"]
    assert r["checks"]["logit_err"]["value"] > 3 * r["checks"]["logit_err"]["limit"]


def _swap_two_requests(monkeypatch) -> list:
    """The batcher hands the first two requests of a coalesced batch each
    other's answers; the list returned fills with one flag a swap, True
    where the two carried different images."""
    from fmcw_radar_processing_tpu_torch.serve.batcher import ClassifyBatcher

    orig = ClassifyBatcher._run
    swapped: list = []

    def swap(self, batch):
        if len(batch) >= 2 and len(batch[0][0]) == len(batch[1][0]):
            (one, f_one), (two, f_two) = batch[:2]
            swapped.append(not np.array_equal(one, two))
            batch = [(one, f_two), (two, f_one), *batch[2:]]
        return orig(self, batch)

    monkeypatch.setattr(ClassifyBatcher, "_run", swap)
    return swapped


def _leave_half_out(monkeypatch) -> None:
    """The forward runs on the first half of each bucket; the second half's
    rows keep a logit of nought (probability 0.5)."""
    clf = _classifier()
    orig = clf._forward

    def half(self, images):
        n = len(images)
        p = orig(self, images[: max(n // 2, 1)])
        return np.concatenate([p, np.full(n, 0.5, p.dtype)])[:n]

    monkeypatch.setattr(clf, "_forward", half)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ("swap", "half"))
def test_faults_read_three_times_the_limit_at_full_size(card, fault, tmp_path, monkeypatch):
    """At the cell's own size (224×224, 8 clients × 8 images) each fault
    reads at least three times the limit on three seeds."""
    from radarbench.tests.conftest import make_root

    root = make_root(tmp_path / "checkout", tiny=False)
    swapped = _swap_two_requests(monkeypatch) if fault == "swap" else _leave_half_out(monkeypatch)
    for seed in (2**31 + 707, 2**31 + 808, 2**31 + 909):
        r = harness.run_cell(root, CELL, seed, 2.0, False, "cuda")
        check = r["checks"]["logit_err"]
        assert not r["correct"] and check["value"] >= 3 * check["limit"], (seed, r["checks"])
    assert swapped is None or any(swapped)
