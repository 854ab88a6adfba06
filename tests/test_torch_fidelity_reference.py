"""PyTorch port: the HTTP service's default profile, the bare
``AlgorithmConfig()``, held on the CPU to the benchmark's plain float64
reference (``radarbench/reference/compare.py``) under the limits of the
cell ``fidelity-1k.recording``.

A seeded recording of the cell's scene (``radarbench/gen/synth.py``) at 256
frames gives about 3,700 valid samples, so nfft 4,096 and nb_pad 2,056:
past 512 bins, where the export is the K4a/K4b pair, run here by its plain
versions. The program passes every limit; the configuration's control (a
bf16 chain, a bf16 intensity, the dB map rounded to bf16) fails one at
least. The benchmark's roofline picks the nfft the program picked. Nothing
here imports JAX or the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from fmcw_radar_processing_tpu_torch.config import (
    AlgorithmConfig,
    RadarConfig,
    default_device_config,
)
from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline
from radarbench import harness, program, roofline
from radarbench.gen import synth
from radarbench.reference import compare

REPO = Path(__file__).resolve().parents[1]
RB = REPO / "radarbench"
CELL = "fidelity-1k.recording"
CFG = json.loads((RB / "configs" / "fidelity-1k.json").read_text())
TRAFFIC = json.loads((RB / "traffic" / "recording.json").read_text())
LIMITS = json.loads((RB / "limits" / f"{CELL}.json").read_text())["limits"]
FRAMES = 256
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recording(seed: int):
    t = TRAFFIC
    raw, calib, _ = synth.recording(
        CFG["device"], CFG["algorithm"], FRAMES, t["targets"],
        gen=synth.generator(seed, CPU), device=CPU, muted_share=t["muted_share"],
        noise_sigma=t["noise_sigma"], dc_offset=tuple(t["dc_offset"]))
    return raw.numpy(), calib.numpy()


def _readings(pipe: RadarPipeline, raw, calib, variant: str):
    """The call's outputs and the numbers compared, the outputs kept as
    the benchmark's recording cells keep them."""
    out = pipe.process_recording(raw, calib)
    kept = program.lower_outputs(
        {"payloads": out.payloads, "detected": out.detected,
         "strength": out.target_strength[0], "db": out.spectrogram_psd_db},
        CFG, variant)
    return out, compare.check_recording(kept, raw, calib, CFG, CPU, TRAFFIC["filename"])


@pytest.mark.parametrize("seed", [2**31 + 2020, 2**31 + 4040])
def test_default_profile_within_the_cells_limits_and_control_not(seed):
    assert CFG["algorithm"] == dataclasses.asdict(AlgorithmConfig())
    raw, calib = _recording(seed)
    cfg = RadarConfig.create(default_device_config(), AlgorithmConfig())
    out, prog = _readings(RadarPipeline(cfg, TRAFFIC["filename"], device="cpu"),
                          raw, calib, "program")
    assert harness.judge(prog, LIMITS)[0], prog

    nb, columns = out.spectrogram_psd_db.shape
    nfft = 2 * (nb - 1)
    assert nfft == 4096 and -(-nb // 8) * 8 > 512  # the tiled pair's bins
    assert roofline.stft_nfft(CFG, columns) == nfft

    ctl_cfg = program.variant_config(CFG, "control")
    ctl = RadarPipeline(program.radar_config(ctl_cfg), TRAFFIC["filename"], device="cpu",
                        impl=ctl_cfg["impl"])
    _, got = _readings(ctl, raw, calib, "control")
    assert not harness.judge(got, LIMITS)[0], got
