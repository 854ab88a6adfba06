"""Classifier robustness: accuracy vs input SNR (the JAX package's
``models/robustness.py``).

Train on clean data, then evaluate on test sets degraded through the same
signal chain:

  * thermal noise at swept input SNR (noise_sigma raised until the
    range-threshold detector itself starts missing targets);
  * amplitude-reduced targets (weaker returns at clean noise);
  * overlapping micro-Doppler signatures: a distractor target drawn from
    the other class in the same range bin, so its modulation mixes into
    the slow-time signal the spectrogram shows.

Every degraded image goes through the full chain on the port's device
(frame chain → packing → STFT → PSD dB → PNG), so the sweep measures the
system — chain detection plus classifier. Per-condition detection rates
are recorded: at low SNR the chain's range threshold
(radar_processing.m:123) stops detecting before the classifier fails.

Input SNR definition: 20·log10(mean target amplitude / noise_sigma), with
the mean amplitude taken over the class specs' sampling ranges.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Sequence

import numpy as np
import torch

from fmcw_radar_processing_tpu_torch.config import RadarConfig, default_device_config
from fmcw_radar_processing_tpu_torch.io.synth import synthesize_recording
from fmcw_radar_processing_tpu_torch.models.data import load_image_folder
from fmcw_radar_processing_tpu_torch.models.dataset_gen import (
    DEFAULT_CLASSES,
    ClassSpec,
    generate_micro_doppler_dataset,
)
from fmcw_radar_processing_tpu_torch.models.train import TrainConfig, Trainer
from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline
from fmcw_radar_processing_tpu_torch.pipeline.spectrogram_image import (
    render_spectrogram_png,
)
from fmcw_radar_processing_tpu_torch.utils.cplx import resolve_device


@dataclasses.dataclass(frozen=True)
class Condition:
    """One degradation setting for a test set."""

    name: str
    noise_sigma: float
    amp_scale: float = 1.0  # multiply every target amplitude
    overlap_ratio: float = 0.0  # other-class distractor amplitude ratio


def mean_amplitude(classes: Sequence[ClassSpec], amp_scale: float = 1.0) -> float:
    return amp_scale * float(
        np.mean([(c.amplitude[0] + c.amplitude[1]) / 2 for c in classes])
    )


def input_snr_db(classes: Sequence[ClassSpec], cond: Condition) -> float:
    return float(
        20.0 * np.log10(
            mean_amplitude(classes, cond.amp_scale)
            / max(cond.noise_sigma, 1e-12)
        )
    )


def snr_conditions(classes: Sequence[ClassSpec],
                   snr_grid_db: Sequence[float]) -> list[Condition]:
    """Noise-sweep conditions hitting the requested input SNRs."""
    amp = mean_amplitude(classes)
    return [
        Condition(name=f"snr_{snr:+.0f}dB",
                  noise_sigma=amp / 10 ** (snr / 20.0))
        for snr in snr_grid_db
    ]


def _scaled(spec: ClassSpec, s: float) -> ClassSpec:
    return dataclasses.replace(
        spec, amplitude=(spec.amplitude[0] * s, spec.amplitude[1] * s)
    )


def _cache_key(fields: dict) -> str:
    """Digest of the parameters that shape a generated set. It includes the
    package, so the JAX package's sets and this one's are never mixed."""
    fields = {**fields, "package": __name__.split(".")[0]}
    return hashlib.sha256(json.dumps(fields, sort_keys=True,
                                     default=str).encode()).hexdigest()


def generate_condition_images(
    out_dir: str,
    classes: Sequence[ClassSpec],
    cond: Condition,
    *,
    images_per_class: int,
    frames_per_recording: int = 128,
    cfg: RadarConfig | None = None,
    seed: int = 0,
    image_size: tuple[int, int] = (1200, 800),
    device: torch.device | str = "cuda",
) -> dict:
    """Generate one degraded image set through the full chain on
    ``device`` (the card unless the caller asks for "cpu").

    Returns {"dir", "detection_rate", "gen_key"} — detection_rate is the
    fraction of frames whose detection lies within ±2 range bins of the
    injected target (true detections: at low SNR the reference's fixed
    threshold false-alarms on noise, so "any detection" says nothing).
    A set is cached under ``out_dir`` keyed on every generation
    parameter; a set with another key, or without its ``stats.json`` (a
    crashed generation), is deleted and regenerated.
    """
    cfg = cfg or RadarConfig.create(default_device_config())
    pipe = RadarPipeline(cfg, device=device)
    gen_key = _cache_key({
        "condition": dataclasses.asdict(cond),
        "classes": [dataclasses.asdict(c) for c in classes],
        "images_per_class": images_per_class,
        "frames_per_recording": frames_per_recording,
        "seed": seed,
        "image_size": list(image_size),
        "cfg": repr(cfg),
    })
    stats_path = os.path.join(out_dir, "stats.json")
    if os.path.exists(stats_path):
        with open(stats_path) as f:
            cached = json.load(f)
        if cached.get("gen_key") == gen_key:
            return cached
        # Parameter mismatch: leftover images of another run would leak
        # into the eval set.
        shutil.rmtree(out_dir)
    elif os.path.isdir(out_dir):
        # stats.json is written last: without it the set is partial.
        shutil.rmtree(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    tol = 2.0 * cfg.derived.dist_per_bin
    detected = total = 0
    for spec in classes:
        cdir = os.path.join(out_dir, spec.name)
        os.makedirs(cdir, exist_ok=True)
        others = [c for c in classes if c.name != spec.name] or [spec]
        for i in range(images_per_class):
            scene = list(_scaled(spec, cond.amp_scale).sample(rng))
            if cond.overlap_ratio > 0.0:
                other = others[int(rng.integers(len(others)))]
                d = other.sample(rng)[0]
                scene.append(dataclasses.replace(
                    d, range_m=scene[0].range_m,
                    amplitude=scene[0].amplitude * cond.overlap_ratio,
                ))
            rec = synthesize_recording(
                cfg, frames_per_recording, tuple(scene),
                noise_sigma=cond.noise_sigma,
                seed=int(rng.integers(0, 2**31 - 1)),
            )
            out = pipe.process_recording(
                rec.rx1_pair(), rec.calib_pair(0, cfg.nts)
            )
            # The strongest target's reported range must sit on the
            # injected target's bin centre.
            true_range = scene[0].range_bin(cfg) * cfg.derived.dist_per_bin
            got = np.nan_to_num(out.target_range[0], nan=np.inf)
            detected += int(np.sum(np.abs(got - true_range) <= tol))
            total += frames_per_recording
            render_spectrogram_png(
                os.path.join(cdir, f"{spec.name}_{i:04d}.png"),
                out.spectrogram_times, out.spectrogram_linear_freqs,
                out.spectrogram_psd_db, size=image_size,
            )
    stats = {"dir": out_dir, "detection_rate": round(detected / total, 4),
             "gen_key": gen_key}
    with open(stats_path, "w") as f:
        json.dump(stats, f)
    return stats


def run_robustness_sweep(
    out_dir: str,
    *,
    model: str = "small",
    classes: Sequence[ClassSpec] = DEFAULT_CLASSES,
    train_images_per_class: int = 64,
    test_images_per_class: int = 24,
    frames_per_recording: int = 128,
    epochs: int = 10,
    batch_size: int = 32,
    learning_rate: float = 1e-4,
    grad_clip_norm: float | None = 1.0,
    image_size: tuple[int, int] = (224, 224),
    render_size: tuple[int, int] = (1200, 800),
    snr_grid_db: Sequence[float] = (40.0, 25.0, 15.0, 10.0, 5.0, 0.0, -5.0),
    extra_conditions: bool = True,
    seed: int = 42,
    mixture_augment: bool = False,
    mixture_frac: float = 0.5,
    mixture_ratio: tuple[float, float] = (0.25, 0.85),
    log_fn=None,
    device: torch.device | str = "cuda",
) -> dict:
    """Train on clean (or mixture-augmented) data; evaluate across the
    degradation grid, on ``device`` (the card unless the caller asks for
    "cpu").

    mixture_augment: train with ``mixture_frac`` of images carrying a
    sub-dominant other-class distractor in the same range bin (labeled by
    the dominant class).

    Returns the report dict (also written to
    ``out_dir/robustness_<model>[_mixture].json``).
    """
    dev = resolve_device(device)
    log = log_fn or (lambda *_: None)
    cfg = RadarConfig.create(default_device_config())

    if mixture_augment:
        train_kind = (f"mixture{mixture_frac:g}_"
                      f"{mixture_ratio[0]:g}-{mixture_ratio[1]:g}")
    else:
        train_kind = "clean"
    # The cached train set's directory: the readable knobs in its name
    # plus a digest of the rest (seed, classes, render size, cfg).
    train_key = _cache_key({
        "classes": [dataclasses.asdict(c) for c in classes],
        "seed": seed, "render_size": list(render_size),
        "cfg": repr(cfg),
    })[:10]
    train_dir = os.path.join(
        out_dir, f"train_{train_kind}_{train_images_per_class}x"
                 f"{frames_per_recording}_{train_key}")
    if not os.path.isdir(train_dir):
        log(f"generating {train_kind} train set "
            f"({train_images_per_class}/class)")
        generate_micro_doppler_dataset(
            train_dir, tuple(classes),
            images_per_class=train_images_per_class,
            frames_per_recording=frames_per_recording,
            cfg=cfg, seed=seed, image_size=render_size,
            mixture_frac=mixture_frac if mixture_augment else 0.0,
            mixture_ratio=mixture_ratio, device=dev,
        )
    imgs, labels, class_names = load_image_folder(train_dir, size=image_size)

    trainer = Trainer(
        model,
        TrainConfig(learning_rate=learning_rate, epochs=epochs,
                    batch_size=batch_size, augment=True, seed=seed,
                    grad_clip_norm=grad_clip_norm),
        input_shape=(*image_size, 3),
        device=dev,
    )
    trainer.fit(imgs, labels, log_fn=log)

    conditions = snr_conditions(classes, snr_grid_db)
    if extra_conditions:
        conditions += [
            Condition("amp_25pct", noise_sigma=0.05, amp_scale=0.25),
            Condition("overlap_0.6", noise_sigma=0.05, overlap_ratio=0.6),
            Condition("overlap_1.0", noise_sigma=0.05, overlap_ratio=1.0),
        ]
    rows = []
    for ci, cond in enumerate(conditions):
        cdir = os.path.join(out_dir, f"test_{cond.name}")
        stats = generate_condition_images(
            cdir, classes, cond,
            images_per_class=test_images_per_class,
            frames_per_recording=frames_per_recording,
            cfg=cfg, seed=seed + 1000 + ci, image_size=render_size,
            device=dev,
        )
        timgs, tlabels, _ = load_image_folder(cdir, size=image_size)
        loss, acc, _ = trainer.evaluate(timgs, tlabels)
        row = {
            "condition": cond.name,
            "input_snr_db": round(input_snr_db(classes, cond), 1),
            "noise_sigma": round(cond.noise_sigma, 4),
            "amp_scale": cond.amp_scale,
            "overlap_ratio": cond.overlap_ratio,
            "detection_rate": stats["detection_rate"],
            "accuracy": round(float(acc), 4),
            "loss": round(float(loss), 4),
            "n_images": int(len(tlabels)),
        }
        rows.append(row)
        log(json.dumps(row))

    # Break point: highest-SNR noise row where accuracy drops below 0.9.
    noise_rows = [r for r in rows if r["condition"].startswith("snr_")]
    broken = [r for r in noise_rows if r["accuracy"] < 0.9]
    break_snr = max((r["input_snr_db"] for r in broken), default=None)
    report = {
        "model": model,
        "classes": list(class_names),
        "train_images_per_class": train_images_per_class,
        "test_images_per_class": test_images_per_class,
        "epochs": epochs,
        "mixture_augment": mixture_augment,
        "mixture_frac": mixture_frac if mixture_augment else 0.0,
        "mixture_ratio": list(mixture_ratio) if mixture_augment else None,
        "history_tail": trainer.history[-1] if trainer.history else None,
        "rows": rows,
        "break_snr_db": break_snr,
        "snr_definition": "20*log10(mean target amplitude / noise_sigma)",
    }
    suffix = "_mixture" if mixture_augment else ""
    with open(os.path.join(out_dir, f"robustness_{model}{suffix}.json"),
              "w") as f:
        json.dump(report, f, indent=2)
    return report


def robustness_markdown(report: dict) -> str:
    lines = [
        f"### Robustness sweep — {report['model']} "
        f"({'/'.join(report['classes'])})",
        "",
        "| condition | input SNR (dB) | detection rate | accuracy | loss |",
        "|---|---|---|---|---|",
    ]
    for r in report["rows"]:
        lines.append(
            f"| {r['condition']} | {r['input_snr_db']} | "
            f"{r['detection_rate']:.2f} | {r['accuracy']:.3f} | "
            f"{r['loss']:.3f} |"
        )
    b = report["break_snr_db"]
    lines.append("")
    lines.append(
        "Break point (first noise row under 0.9 accuracy): "
        + (f"{b} dB input SNR." if b is not None
           else "none within the swept grid.")
    )
    return "\n".join(lines)
