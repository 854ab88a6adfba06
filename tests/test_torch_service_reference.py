"""PyTorch port: the HTTP service's ``POST /process`` at its default
profile, held on the CPU to the benchmark's plain reference of the service
cell (``radarbench/reference/service.py``) under the limits of
``service-1k.process``.

A ``RadarHttpService`` on 127.0.0.1 (port 0) serves a seeded recording of
the cell's scene at 64 frames, written as the sensor's file pair into
``LocalStorage``; the request's artifacts, read back from the blob storage,
pass every limit. Each fault planted after or inside the request reads over
the limit it is meant for. Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import json
import shutil
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from fmcw_radar_processing_tpu_torch.serve import handler
from fmcw_radar_processing_tpu_torch.serve.handler import HandlerConfig
from fmcw_radar_processing_tpu_torch.serve.http_service import RadarHttpService
from radarbench import harness, program
from radarbench.drivers.service import read_blobs, write_upload
from radarbench.gen import synth
from radarbench.reference import service as ref_service

REPO = Path(__file__).resolve().parents[1]
RB = REPO / "radarbench"
CELL = "service-1k.process"
CFG = json.loads((RB / "configs" / "service-1k.json").read_text())
TRAFFIC = json.loads((RB / "traffic" / "process.json").read_text())
LIMITS = json.loads((RB / "limits" / f"{CELL}.json").read_text())["limits"]
NAME = TRAFFIC["filename"]
FRAMES = 64
SEED = 2**31 + 2424
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve_one(root: Path, seed: int = SEED):
    """One 'no' request over a recording written into a fresh blob storage
    under ``root``: (blob directory, the step-status JSON, the first
    antenna's chirps, its calibration)."""
    t = TRAFFIC
    gen = synth.generator(seed, CPU)
    draws = [synth.recording(CFG["device"], CFG["algorithm"], FRAMES, t["targets"],
                             gen=gen, device=CPU, muted_share=t["muted_share"],
                             noise_sigma=t["noise_sigma"], dc_offset=tuple(t["dc_offset"]))
             for _ in range(2)]
    (raw, calib, _), (raw1, _, _) = draws
    raw, calib, raw1 = raw.numpy(), calib.numpy(), raw1.numpy()
    blobs, work = root / "blobs", root / "work"
    blobs.mkdir(parents=True)
    work.mkdir()
    write_upload(str(blobs / NAME), [raw, raw1], calib, program.radar_config(CFG).device)
    svc = CFG["service"]
    hc = HandlerConfig(fdata=NAME, workdir=str(work), storage_spec=f"local:{blobs}",
                       pretty_json=svc["pretty_json"], upload=svc["upload"],
                       profile=svc["profile"], device="cpu")
    with RadarHttpService(hc, port=0, host="127.0.0.1") as srv:
        req = urllib.request.Request(srv.url + "process",
                                     data=json.dumps(t["request"]).encode(),
                                     headers={"Content-Type": "application/json"})
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        with opener.open(req, timeout=120) as r:
            response = json.loads(r.read())
    return blobs, response, raw, calib


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return _serve_one(tmp_path_factory.mktemp("served"))


def _readings(blobs, response, raw, calib):
    return ref_service.check_service(read_blobs(str(blobs), NAME), response, raw, calib,
                                     CFG, CPU, NAME)


def test_process_within_the_cells_limits(served):
    blobs, response, raw, calib = served
    assert response["status"] == "success", response
    assert sorted(p.name for p in blobs.iterdir()) == sorted(
        ref_service.artifact_names(NAME) + [NAME + ".xml", NAME + ".raw.bin"])
    got = _readings(blobs, response, raw, calib)
    assert set(got) == set(LIMITS)
    assert harness.judge(got, LIMITS)[0], got
    assert got["response_faults"] == got["detect_faults"] == got["payload_faults"] == 0


def _copy(served, tmp_path):
    blobs, response, raw, calib = served
    copy = tmp_path / "blobs"
    shutil.copytree(blobs, copy)
    return copy, response, raw, calib


def _intensity_altered(served, tmp_path, monkeypatch):
    """The spectrogram artifact's largest intensity value lowered by 1e-3."""
    out = _copy(served, tmp_path)
    path = out[0] / "spectrogram_data.json"
    p = json.loads(path.read_text())
    r, c = np.unravel_index(np.argmax(np.asarray(p["intensity"], np.float64)),
                            (len(p["intensity"]), len(p["intensity"][0])))
    p["intensity"][r][c] -= 1e-3
    path.write_text(json.dumps(p))
    return out


def _artifact_deleted(served, tmp_path, monkeypatch):
    out = _copy(served, tmp_path)
    (out[0] / f"{NAME}_fft_data.json").unlink()
    return out


def _clim_shifted(served, tmp_path, monkeypatch):
    """A request whose PNG is rendered with the clim shifted by 1 dB."""
    render = handler.render_spectrogram_png

    def shifted(*args, **kw):
        return render(*args, clim=(-39.0, 1.0), **kw)

    monkeypatch.setattr(handler, "render_spectrogram_png", shifted)
    return _serve_one(tmp_path, SEED + 1)


@pytest.mark.parametrize("fault,reading", [
    (_intensity_altered, "intensity_err"),
    (_artifact_deleted, "response_faults"),
    (_clim_shifted, "image_err"),
], ids=["intensity", "artifact", "clim"])
def test_a_planted_fault_reads_over_its_limit(served, tmp_path, monkeypatch, fault, reading):
    got = _readings(*fault(served, tmp_path, monkeypatch))
    assert got[reading] > LIMITS[reading], got
    assert not harness.judge(got, LIMITS)[0]
