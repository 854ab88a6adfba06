"""PyTorch port: the classifier on one CUDA card.

VGG16 at its published input, 224×224×3, from Flax's default
initialization drawn by a seeded generator on the card: its artifact's
round trip, bf16 logits against float32 ones, a lone image against the
same image in a padded bucket, and the HTTP service serving it beside the
recording path. The training path: VGG16 steps (batch 32, Adam 1e-4,
augmentation on the card) with a frozen backbone and in full, and one
float32 step against the same step on the CPU, both marked ``slow``; the
toy ``run_classifier_experiment`` of the JAX package's test, its images
made by the chain on the card; and a two-point robustness sweep. Every
test needs a card and skips without one. None imports JAX: the card's
machine has no Flax, so the CPU tests of these modules, which compare
with the JAX package's Flax models, are elsewhere.
"""

from __future__ import annotations

import base64
import concurrent.futures
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from fmcw_radar_processing_tpu_torch import (
    AlgorithmConfig,
    LocalStorage,
    RadarConfig,
    SyntheticTarget,
    default_device_config,
    synthesize_recording,
    write_recording,
)
from fmcw_radar_processing_tpu_torch.models.data import augment_batch
from fmcw_radar_processing_tpu_torch.models.experiment import (
    ExperimentConfig,
    run_classifier_experiment,
)
from fmcw_radar_processing_tpu_torch.models.infer import (
    SpectrogramClassifier,
    export_classifier,
)
from fmcw_radar_processing_tpu_torch.models.params import state_dict_to_flax
from fmcw_radar_processing_tpu_torch.models.robustness import run_robustness_sweep
from fmcw_radar_processing_tpu_torch.models.train import (
    TrainConfig,
    Trainer,
    make_train_step,
)
from fmcw_radar_processing_tpu_torch.models.vgg import build_model, init_flax_default_
from fmcw_radar_processing_tpu_torch.ops import _lib
from fmcw_radar_processing_tpu_torch.serve.dashboard import DashboardServer
from fmcw_radar_processing_tpu_torch.serve.handler import HandlerConfig
from fmcw_radar_processing_tpu_torch.serve.http_service import RadarHttpService
from fmcw_radar_processing_tpu_torch.utils.cplx import pin_f32_matmul

SEED = 20261016
SHAPE = (224, 224, 3)
# The toy experiment of the JAX package's test (test_experiment.py:60-75).
TOY_EXPERIMENT = dict(images_per_class=10, frames_per_recording=48,
                      image_size=(64, 64), model="small", epochs=30,
                      batch_size=7, learning_rate=1e-3, augment=False,
                      render_size=(320, 240))
# The chain's kernels of the bare AlgorithmConfig at 48 frames (nfft 1,024,
# nb_pad past 272): K1a, then K4a and K4b, once a recording.
CHAIN_KERNELS = {"fast_time_profile_b3", "psd_phase1_tiled", "db_rescale_tiled"}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pin_f32_matmul()
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def vgg16(card, tmp_path_factory):
    """(VGG16 in float32 on the card, its exported artifact's directory)."""
    gen = torch.Generator(device=card).manual_seed(SEED)
    model = init_flax_default_(build_model("vgg16", SHAPE, dtype=torch.float32,
                                           device=card), gen)
    art = export_classifier(str(tmp_path_factory.mktemp("vgg16") / "vgg16"), "vgg16",
                            state_dict_to_flax(model.state_dict()), SHAPE,
                            ("calf", "human"))
    return model, art


@pytest.mark.cuda
def test_vgg16_artifact_and_bf16_inference_on_card(card, vgg16):
    """The artifact loads to the same parameters; its bf16 logits of 8
    images are within 5e-2·max Σ|w·h| of float32's (the last Dense's
    terms: logits of random weights are small sums of larger terms, so the
    bound scales with the terms); one image alone gives the probability it
    gets inside a padded bucket of 8, within 2e-3."""
    f32, art = vgg16
    clf = SpectrogramClassifier.load(art, card)
    ref = f32.state_dict()
    for k, v in clf.model.state_dict().items():
        assert torch.equal(v, ref[k]), k
    x = np.random.default_rng(SEED + 4).uniform(0, 1, (8, *SHAPE)).astype(np.float32)
    xd = torch.as_tensor(x, device=card)
    with torch.inference_mode():
        l32 = f32(xd).float()
        l16 = clf.model(xd).float()
        feats = f32.backbone(xd.permute(0, 3, 1, 2))
        h = torch.relu(f32.head.fc(feats.permute(0, 2, 3, 1).flatten(1)))
        terms = float((h * f32.head.out.weight[0]).abs().sum(1).max())
    assert float((l16 - l32).abs().max()) <= 5e-2 * terms
    p1 = clf.predict_proba(x[:1])
    p5 = clf.predict_proba(x[:5])  # bucket 8, three padded rows
    assert abs(p1[0] - p5[0]) <= 2e-3


def _post(url, body: bytes, ctype="application/json"):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


@pytest.mark.cuda
def test_http_service_with_vgg16_on_card(card, vgg16, tmp_path):
    """RadarHttpService on 127.0.0.1 (its default profile, fidelity) with
    the VGG16 artifact, on a 256-frame recording in local blob storage:
    /process "no" and "yes" succeed; the dashboard's manifest names every
    payload, the PNG and three batches; /classify answers the PNG alone,
    eight concurrent requests (coalesced into one batch within three
    rounds), and 1, 8 and 64 images in one request."""
    cfg = RadarConfig.create(default_device_config(), AlgorithmConfig.production())
    rec = synthesize_recording(
        cfg, 256, (SyntheticTarget(range_m=7.5, doppler_bin_offset=3, amplitude=4.0),
                   SyntheticTarget(range_m=16.9, doppler_bin_offset=-2, amplitude=2.0)),
        seed=SEED + 1,
        target_present=np.random.default_rng(SEED).random(65_536)[:256] >= 0.1)
    blobs, work = str(tmp_path / "blobs"), str(tmp_path / "work")
    os.makedirs(work)
    store = LocalStorage(blobs)
    xml, bin_ = write_recording(str(tmp_path / "radar_data"), rec)
    store.put(xml, "radar_data.xml")
    store.put(bin_, "radar_data.raw.bin")
    hc = HandlerConfig(workdir=work, storage_spec=f"local:{blobs}", pretty_json=False,
                       device=str(card))
    assert hc.profile == "fidelity"
    with RadarHttpService(hc, port=0, classifier_artifact=vgg16[1]) as srv:
        for flag in ("no", "yes"):
            st, res = _post(srv.url + "process",
                            json.dumps({"processAnimalActivity": flag}).encode())
            assert st == 200 and res["status"] == "success", res
        with DashboardServer(work, port=0) as dash:
            man = _get(dash.url + "api/manifest")
            with urllib.request.urlopen(dash.url + "data/spectrogram.png",
                                        timeout=60) as r:
                png = r.read()
        assert None not in (man["spectrogram"], man["range_fft"], man["range_speed"],
                            man["fft_snapshot"], man["png"]), man
        assert len(man["batches"]) == 3 and png.startswith(b"\x89PNG")

        st, res = _post(srv.url + "classify", png, "image/png")
        assert st == 200 and len(res["predictions"]) == 1

        for _ in range(3):  # released together until a batch coalesces
            gate = threading.Barrier(8)

            def one(_):
                gate.wait(timeout=60)
                return _post(srv.url + "classify", png, "image/png")

            with concurrent.futures.ThreadPoolExecutor(8) as ex:
                res8 = [f.result(timeout=300)
                        for f in [ex.submit(one, i) for i in range(8)]]
            assert all(st == 200 for st, _ in res8)
            if _get(srv.url + "healthz")["classify_batching"]["max_batch"] > 1:
                break
        assert _get(srv.url + "healthz")["classify_batching"]["max_batch"] > 1

        b64 = base64.b64encode(png).decode()
        for n in (1, 8, 64):
            st, res = _post(srv.url + "classify",
                            json.dumps({"images_b64": [b64] * n}).encode())
            assert st == 200 and len(res["predictions"]) == n


@pytest.mark.cuda
@pytest.mark.slow
@pytest.mark.parametrize("freeze", [True, False], ids=["frozen", "full"])
def test_vgg16_train_steps_on_card(card, freeze):
    """VGG16 at 224×224×3, batch 32, bf16 compute on float32 parameters,
    Adam 1e-4, augmentation on the card (the notebook's transfer setup):
    three steps give finite losses and move every head parameter; the
    frozen backbone stays bit-unchanged, a trained one moves everywhere."""
    trainer = Trainer("vgg16", TrainConfig(learning_rate=1e-4, freeze_backbone=freeze,
                                           batch_size=32),
                      input_shape=SHAPE, device=card)
    step = make_train_step(trainer.model, trainer.optimizer)
    gen = torch.Generator(device=card).manual_seed(SEED + 6)
    x = torch.rand((32, *SHAPE), generator=gen, device=card)
    y = (torch.arange(32, device=card) % 2).to(torch.float32)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    losses = [step(augment_batch(trainer.aug_generator, x), y,
                   trainer.drop_generator)["loss"] for _ in range(3)]
    assert bool(torch.isfinite(torch.stack(losses).float()).all())
    after = trainer.model.state_dict()
    moved = {k: not torch.equal(v, after[k]) for k, v in before.items()}
    assert all(moved[k] for k in moved if k.startswith("head."))
    backbone = [moved[k] for k in moved if k.startswith("backbone.")]
    assert (not any(backbone)) if freeze else all(backbone)


@pytest.mark.cuda
@pytest.mark.slow
def test_vgg16_float32_step_on_card_matches_cpu(card):
    """One float32 step, dropout off, batch 4, on the card and on the CPU
    from the same parameters and batch (TF32 off). Two float32 sum orders
    send a few pre-activations to the other side of a ReLU or a max-pool,
    so the early layers' gradients differ by percent: the CPU's own float32
    step at this shape differs from a float64 step by at most 2.0e-2 of a
    leaf's L2 norm, and its Adam step by more than 1e-2·lr on 0.6% of the
    elements. Bounds: the loss within 1e-5 relative; each gradient leaf
    within 5e-2 of its L2 norm; every parameter within 2·lr (Adam's first
    step is lr·g/(|g| + ε): a gradient near rounding may take the other
    sign), at most 2% of them off by more than 1e-2·lr."""
    lr = 1e-4
    cfg = TrainConfig(learning_rate=lr, augment=False)
    on_card = Trainer("vgg16", cfg, input_shape=SHAPE, device=card, dtype=torch.float32)
    on_cpu = Trainer("vgg16", cfg, input_shape=SHAPE, device="cpu", dtype=torch.float32)
    on_cpu.set_params(on_card.params)
    x = np.random.default_rng(SEED + 7).uniform(0, 1, (4, *SHAPE)).astype(np.float32)
    y = (np.arange(4) % 2).astype(np.float32)
    out = {}
    for name, t in (("card", on_card), ("cpu", on_cpu)):
        t.model.head.dropout = 0.0
        loss = make_train_step(t.model, t.optimizer)(
            torch.as_tensor(x).to(t.device), torch.as_tensor(y).to(t.device), None)["loss"]
        out[name] = (float(loss), {k: (p.detach().cpu(), p.grad.cpu())
                                   for k, p in t.model.named_parameters()})
    (l_card, s_card), (l_cpu, s_cpu) = out["card"], out["cpu"]
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    far = total = 0
    for k, (p_cpu, g_cpu) in s_cpu.items():
        p_card, g_card = s_card[k]
        assert float((g_card - g_cpu).norm() / g_cpu.norm()) <= 5e-2, k
        d = (p_card - p_cpu).abs()
        assert float(d.max()) <= (2.0 + 1e-3) * lr, k
        far += int((d > 1e-2 * lr).sum())
        total += d.numel()
    assert far <= 2e-2 * total


@pytest.mark.cuda
def test_toy_experiment_on_card(card, tmp_path):
    """The JAX package test's toy experiment on the card: its images made
    by the chain (K1a, K4a and K4b once a recording, nothing else), final
    train accuracy at least 0.8 (that test's bar), the round trip served
    from the port's artifact, and the report naming the card."""
    cfg = ExperimentConfig(**TOY_EXPERIMENT)
    _lib.reset_launches()
    report = run_classifier_experiment(str(tmp_path / "experiment"), cfg, device=card)
    launches = {k: n for k, n in _lib.LAUNCHES.items() if n}
    assert launches == {k: 2 * cfg.images_per_class for k in CHAIN_KERNELS}
    assert report["training"]["history"][-1]["accuracy"] >= 0.8
    rt = report["serving_roundtrip"]
    assert rt["sampled"] == 2
    assert os.path.exists(os.path.join(rt["artifact"], "params.npz"))
    assert report["device"]["device_kind"] == torch.cuda.get_device_name(card)


@pytest.mark.cuda
def test_robustness_sweep_on_card(card, tmp_path):
    """A two-point robustness sweep (SNR +30 and 0 dB, SmallCNN, 48
    frames, two epochs) on the card: the report's keys and one row a
    condition with the row keys of the JAX package's report."""
    sweep = run_robustness_sweep(
        str(tmp_path / "robustness"), model="small", train_images_per_class=4,
        test_images_per_class=2, frames_per_recording=48, epochs=2, batch_size=4,
        image_size=(64, 64), render_size=(320, 240), snr_grid_db=(30.0, 0.0),
        extra_conditions=False, device=card)
    assert set(sweep) == {"model", "classes", "train_images_per_class",
                          "test_images_per_class", "epochs", "mixture_augment",
                          "mixture_frac", "mixture_ratio", "history_tail", "rows",
                          "break_snr_db", "snr_definition"}
    rows = sweep["rows"]
    assert [r["condition"] for r in rows] == ["snr_+30dB", "snr_+0dB"]
    assert all(set(r) == {"condition", "input_snr_db", "noise_sigma", "amp_scale",
                          "overlap_ratio", "detection_rate", "accuracy", "loss",
                          "n_images"} for r in rows)
