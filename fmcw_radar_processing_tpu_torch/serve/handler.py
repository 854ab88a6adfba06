"""Service handler — the ``main(input)`` endpoint of the reference
(radar_processing_with_azure.m:9-100), on the PyTorch pipeline.

Same request/response contract and steps as the JAX package's
``serve/handler.py``:

    input:  {"processAnimalActivity": "yes"|"no"}
    output: {"status": "success"|"error", "message": str,
             "steps": [{"step", "status", "message"}, ...]}

Steps: Read Files → Radar Processing → Upload JSON, each failing early
with the reference's messages. "no" writes the four payloads and the PNG;
"yes" (activity mode) writes one spectrogram JSON per batch.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable

from fmcw_radar_processing_tpu.config import AlgorithmConfig, RadarConfig
from fmcw_radar_processing_tpu.io.raw_format import read_recording
from fmcw_radar_processing_tpu.io.storage import Storage, get_storage
from fmcw_radar_processing_tpu.utils.jsonio import write_json
from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline
from fmcw_radar_processing_tpu_torch.pipeline.spectrogram_image import (
    render_spectrogram_png,
)
from fmcw_radar_processing_tpu_torch.utils.cplx import to_pair


@dataclasses.dataclass
class HandlerConfig:
    fdata: str = "radar_data"  # base recording name
    workdir: str = "."
    storage_spec: str | None = None
    retries: int = 3
    pretty_json: bool = True  # reference 'PrettyPrint' fidelity; False = fast/compact
    retry_backoff_s: float = 0.5
    upload: bool = True
    # "fidelity" (the bare AlgorithmConfig: the reference's hop-1 /
    # nfft = 2^nextpow2 STFT and float32 artifacts) or "production"
    # (AlgorithmConfig.production(): 256-point STFT, bf16 intensity).
    profile: str = "fidelity"
    device: str = "cuda"


def _retry(fn: Callable[[], Any], retries: int, backoff: float):
    last: Exception | None = None
    for attempt in range(retries):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — step status captures it
            last = e
            if attempt + 1 < retries:
                time.sleep(backoff * (2**attempt))
    raise last  # type: ignore[misc]


def load_recording(basepath: str):
    """<base>.{xml,raw.bin} → (raw [F, PN, 2·NTS] f32, calib [NTS, 2] f32,
    DeviceConfig), the rx1 chirps paired in NumPy."""
    rec = read_recording(basepath)
    nts = rec.device.nts
    raw = to_pair(rec.rx1())
    return (raw.reshape(*raw.shape[:2], 2 * nts),
            to_pair(rec.calib_vector(0, nts)), rec.device)


class RadarService:
    """Stateful service: storage + pipelines, reused across requests."""

    def __init__(self, config: HandlerConfig | None = None,
                 storage: Storage | None = None):
        self.config = config or HandlerConfig()
        self.storage = storage or get_storage(self.config.storage_spec)
        self._pipelines: dict[tuple, RadarPipeline] = {}

    def _download(self) -> str:
        """Step 1: fetch <fdata>.xml + <fdata>.raw.bin."""
        base = os.path.join(self.config.workdir, self.config.fdata)
        for ext in (".xml", ".raw.bin"):
            name = self.config.fdata + ext
            _retry(
                lambda n=name, e=ext: self.storage.get(n, base + e),
                self.config.retries,
                self.config.retry_backoff_s,
            )
        return base

    def _upload(self, path: str, content_type: str) -> int:
        if not self.config.upload:
            return 0
        name = os.path.basename(path)
        _retry(
            lambda: self.storage.put(path, name, content_type),
            self.config.retries,
            self.config.retry_backoff_s,
        )
        return 1

    def _pipeline_for(self, cfg: RadarConfig) -> RadarPipeline:
        key = (cfg.device, cfg.algorithm)
        if key not in self._pipelines:
            self._pipelines[key] = RadarPipeline(
                cfg, filename=self.config.fdata, device=self.config.device)
        return self._pipelines[key]

    def _process(self, basepath: str, activity: bool) -> tuple[list[str], int]:
        """Step 2: the signal chain + JSON/PNG export + upload
        (radar_processing.m:195-436 'no' / :440-607 'yes').
        Returns (written paths, uploads)."""
        raw, calib, device = load_recording(basepath)
        if self.config.profile == "production":
            cfg = RadarConfig.create(device, AlgorithmConfig.production())
        else:
            cfg = RadarConfig.create(device)
        pipe = self._pipeline_for(cfg)
        if activity:  # one JSON per batch (:593), no PNG
            out = None
            payloads = [(b.filename, b.payload)
                        for b in pipe.process_activity(raw, calib)]
        else:
            out = pipe.process_recording(raw, calib)
            payloads = list(out.payloads.items())
        written: list[str] = []
        uploaded = 0
        for name, payload in payloads:
            path = os.path.join(self.config.workdir, name)
            write_json(path, payload, pretty=self.config.pretty_json)
            uploaded += self._upload(path, "application/json")
            written.append(path)
        if out is not None:
            png = os.path.join(self.config.workdir, "spectrogram.png")
            # The reference renders the LINEAR-frequency dB PSD
            # (radar_processing.m:331-340); only the JSON is log-rescaled.
            render_spectrogram_png(png, out.spectrogram_times,
                                   out.spectrogram_linear_freqs,
                                   out.spectrogram_psd_db)
            uploaded += self._upload(png, "image/png")  # :348
            written.append(png)
        return written, uploaded

    def main(self, request: dict | None = None) -> dict:
        """The ``main(input)`` endpoint (radar_processing_with_azure.m:9)."""
        request = request or {}
        flag = str(request.get("processAnimalActivity", "no")).lower()  # :16-22
        activity = flag == "yes"
        steps: list[dict] = []

        def fail(step: str, exc: Exception, message: str) -> dict:
            steps.append(
                {"step": step, "status": "error", "message": str(exc)}
            )
            return {"status": "error", "message": message, "steps": steps}

        t0 = time.perf_counter()
        try:
            basepath = self._download()
            steps.append({
                "step": "Read Files",
                "status": "success",
                "message": "Files downloaded from storage successfully.",
                "duration_s": round(time.perf_counter() - t0, 4),
            })
        except Exception as e:  # :38-45
            return fail("Read Files", e, "Failed at reading files from blob storage.")

        t1 = time.perf_counter()
        try:
            written, uploaded = self._process(basepath, activity)
            steps.append({
                "step": "Radar Processing",
                "status": "success",
                "message": "Radar data processed successfully.",
                "artifacts": [os.path.basename(w) for w in written],
                "duration_s": round(time.perf_counter() - t1, 4),
            })
        except Exception as e:  # :56-66
            return fail("Radar Processing", e, "Failed at radar processing step.")

        if self.config.upload:
            steps.append({
                "step": "Upload JSON",
                "status": "success",
                "message": f"Uploaded {uploaded} artifact(s) to storage.",
            })
        else:
            steps.append({
                "step": "Upload JSON",
                "status": "skipped",
                "message": "Upload disabled; artifacts written locally only.",
            })
        return {
            "status": "success",
            "message": "All steps completed successfully.",
            "steps": steps,
        }


def main(request: dict | None = None, config: HandlerConfig | None = None) -> dict:
    """Module-level convenience endpoint (one-shot service)."""
    return RadarService(config).main(request)
