"""Synthetic micro-Doppler dataset generation — closing the classifier loop
(the JAX package's ``models/dataset_gen.py``).

The reference trains its DCNN on micro-Doppler spectrogram PNGs of humans
vs calves recorded in the field (Main_FYP_DCNN_training.ipynb cells 9-16:
human 192 / calf 192 images, split 134/29/29 per class). The field
recordings are not in the repo, so the dataset is regenerated: each class
is a family of targets with a distinct micro-Doppler signature
(modulation rate and depth, bulk speed), and every image goes through the
real signal chain — the port's ``RadarPipeline`` (frame chain → slow-time
packing → STFT → linear-frequency dB PSD) on its device, then a PNG —
the path a field recording takes (radar_processing.m:195-348).

Scenes are drawn with NumPy only, so a seed gives the JAX package's
scenes; the images then differ from the JAX package's only by the chain's
rounding.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from fmcw_radar_processing_tpu_torch.config import RadarConfig, default_device_config
from fmcw_radar_processing_tpu_torch.io.synth import (
    SyntheticTarget,
    synthesize_recording,
)
from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline
from fmcw_radar_processing_tpu_torch.pipeline.spectrogram_image import (
    render_spectrogram_png,
)


@dataclasses.dataclass(frozen=True)
class ClassSpec:
    """Parameter family for one target class (all ranges inclusive).

    Each sampled scene is the moving target plus a static clutter return in
    the same range bin. The chain takes |slow-time| before the STFT
    (radar_processing.m:270), which discards absolute phase: the static
    return is the interference reference that turns the target's
    micro-Doppler phase modulation into the amplitude modulation the
    spectrogram shows. Field recordings always contain such clutter.
    """

    name: str
    md_rate_hz: tuple[float, float]  # micro-Doppler modulation rate
    md_phase_rad: tuple[float, float]  # modulation depth
    doppler_offset: tuple[int, int]  # |bulk Doppler bin offset| (sign random)
    range_m: tuple[float, float] = (4.0, 20.0)
    amplitude: tuple[float, float] = (3.0, 6.0)
    clutter_ratio: tuple[float, float] = (0.4, 0.8)  # clutter/target amplitude

    def sample(self, rng: np.random.Generator) -> tuple[SyntheticTarget, ...]:
        off = int(rng.integers(self.doppler_offset[0], self.doppler_offset[1] + 1))
        sign = 1 if rng.random() < 0.5 else -1
        tgt = SyntheticTarget(
            range_m=float(rng.uniform(*self.range_m)),
            doppler_bin_offset=sign * off,
            amplitude=float(rng.uniform(*self.amplitude)),
            md_phase_rad=float(rng.uniform(*self.md_phase_rad)),
            md_rate_hz=float(rng.uniform(*self.md_rate_hz)),
        )
        clutter = SyntheticTarget(
            range_m=tgt.range_m,  # same range bin by construction
            doppler_bin_offset=0,
            amplitude=tgt.amplitude * float(rng.uniform(*self.clutter_ratio)),
        )
        return (tgt, clutter)


# The notebook's three field signatures (human/calf/bees — cells 9-16 and
# 27-29). The bulk-Doppler carrier sits at |offset|·fs/PN (78 Hz a bin at
# the default config), inside the PNG's 0-150 Hz window
# (radar_processing.m:336) for offset 1; the sidebands fan out at multiples
# of the gait rate: a human's fast, deep limb modulation smears energy
# across the band; a calf's slow, shallow one stays near the carrier; a bee
# swarm is near-stationary with very fast, shallow wing-beat flutter.
HUMAN = ClassSpec("human", md_rate_hz=(30.0, 70.0), md_phase_rad=(1.5, 3.0),
                  doppler_offset=(1, 2))
CALF = ClassSpec("calf", md_rate_hz=(6.0, 24.0), md_phase_rad=(0.4, 1.2),
                 doppler_offset=(1, 1))
BEES = ClassSpec("bees", md_rate_hz=(90.0, 150.0), md_phase_rad=(0.15, 0.5),
                 doppler_offset=(0, 1), amplitude=(2.0, 4.0),
                 clutter_ratio=(0.6, 1.0))
DEFAULT_CLASSES: tuple[ClassSpec, ...] = (CALF, HUMAN)
CLASS_SPECS: dict[str, ClassSpec] = {c.name: c for c in (HUMAN, CALF, BEES)}


def generate_micro_doppler_dataset(
    out_dir: str,
    classes: tuple[ClassSpec, ...] = DEFAULT_CLASSES,
    *,
    images_per_class: int = 192,  # reference dataset size (BASELINE.md)
    frames_per_recording: int = 128,
    cfg: RadarConfig | None = None,
    noise_sigma: float = 0.05,
    seed: int = 0,
    image_size: tuple[int, int] = (1200, 800),
    mixture_frac: float = 0.0,
    mixture_ratio: tuple[float, float] = (0.25, 0.85),
    device: torch.device | str = "cuda",
) -> dict[str, list[str]]:
    """Generate ``out_dir/<class>/<class>_<i>.png`` spectrogram images, each
    recording through the port's chain on ``device`` (the card unless the
    caller asks for "cpu"; "cuda" without a card raises RuntimeError).
    Returns {class_name: [png paths]}.

    mixture_frac: the fraction of each class's images that also contain a
    distractor target drawn from another class, in the primary target's
    range bin at amplitude primary × U(*mixture_ratio), still labeled as
    the primary class (dominant-signature training; the robustness sweep's
    overlap condition is the same construction).
    """
    cfg = cfg or RadarConfig.create(default_device_config())
    pipe = RadarPipeline(cfg, device=device)
    rng = np.random.default_rng(seed)
    result: dict[str, list[str]] = {}
    for spec in classes:
        cdir = os.path.join(out_dir, spec.name)
        os.makedirs(cdir, exist_ok=True)
        paths = []
        others = [c for c in classes if c.name != spec.name] or [spec]
        for i in range(images_per_class):
            scene = list(spec.sample(rng))
            if mixture_frac > 0.0 and rng.random() < mixture_frac:
                other = others[int(rng.integers(len(others)))]
                d = other.sample(rng)[0]
                scene.append(dataclasses.replace(
                    d, range_m=scene[0].range_m,
                    amplitude=scene[0].amplitude
                    * float(rng.uniform(*mixture_ratio)),
                ))
            scene = tuple(scene)
            rec = synthesize_recording(
                cfg, frames_per_recording, scene,
                noise_sigma=noise_sigma,
                seed=int(rng.integers(0, 2**31 - 1)),
            )
            out = pipe.process_recording(rec.rx1_pair(), rec.calib_pair(0, cfg.nts))
            path = os.path.join(cdir, f"{spec.name}_{i:04d}.png")
            # Linear-frequency PSD — what surf(T, F, psd) exports and what
            # the reference's classifier was trained on
            # (radar_processing.m:331-348).
            render_spectrogram_png(
                path, out.spectrogram_times, out.spectrogram_linear_freqs,
                out.spectrogram_psd_db, size=image_size,
            )
            paths.append(path)
        result[spec.name] = paths
    return result
