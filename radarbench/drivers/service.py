"""Uploads served one at a time through the port's HTTP service: the
reference's MPS function ``main(input)`` (radar_processing_with_azure.m:
9-100) behind ``POST /process`` on 127.0.0.1, a real socket.

A call is what one sensor's upload costs the service: the client puts the
recording's ``<filename>.{xml,raw.bin}`` into the blob storage the service
reads (a copy of about 17 MB), POSTs the request and reads the step-status
JSON. The service downloads the pair to its workdir, runs the chain and the
export, writes the four JSON artifacts and the PNG there and uploads all
five back to the blob storage (serve/handler.py::RadarService.main).

Traffic keys: "entry" ("/process"), "request" (the request's JSON body),
"pool" (distinct recordings made from the seed, sent in turn), "targets",
"muted_share", "noise_sigma", "dc_offset" (the scene), "trace_items"
(calls in the traced slice), "check_items" (calls whose artifacts are kept
for the comparison), "filename". The configuration's "service" section
gives the handler's profile, pretty JSON, upload and storage.

The program's path is reached through the port's serve and io entry
points alone. For the control, this module builds a RadarPipeline of the
configuration's lower-precision paths and puts it into the service's
pipeline cache under the profile's key, so that the service runs it in
the program's place.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import sys
import tempfile
import time
import urllib.request

import numpy as np

from radarbench import program, roofline
from radarbench import trace as tr
from radarbench.gen import synth
from radarbench.reference import service as ref_service

REQUEST_TIMEOUT_S = 900.0


def write_upload(base: str, chirps: list, calib: np.ndarray, device_cfg) -> tuple[str, str]:
    """The sensor's file pair ``<base>.{xml,raw.bin}`` of one recording:
    antenna r's chirps are ``chirps[r]``, flat pair rows [F, PN, 2·NTS]
    float32; ``calib`` [NTS, 2] is every antenna's calibration, written as
    2·NTS I and Q samples that the reader decimates by 2. The container
    holds float32, so the chain reads back exactly these arrays."""
    from fmcw_radar_processing_tpu_torch.io.raw_format import RawRecording, write_recording

    f, pn, row = chirps[0].shape
    frames = np.stack([np.asarray(c, np.float32).reshape(f, pn, row // 2, 2)
                       for c in chirps], axis=1)
    frames = np.ascontiguousarray(frames).view(np.complex64)[..., 0]
    cal = np.repeat(np.asarray(calib, np.float32).T, 2, axis=1)
    return write_recording(base, RawRecording(frames=frames,
                                              calib=np.stack([cal] * len(chirps)),
                                              device=device_cfg))


def read_blobs(blob_dir: str, filename: str) -> dict:
    """The request's artifacts found in ``blob_dir``, by name, as a user
    reads them: each JSON one parsed with ``json``, the PNG decoded to uint8
    RGB."""
    from PIL import Image

    out = {}
    for name in ref_service.artifact_names(filename):
        path = os.path.join(blob_dir, name)
        if not os.path.isfile(path):
            continue
        if name == ref_service.PNG:
            with Image.open(path) as im:
                out[name] = np.asarray(im.convert("RGB"))
        else:
            with open(path) as f:
                out[name] = json.load(f)
    return out


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, out_dir,
                 variant: str = "program"):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.variant = device, variant
        self.run_cfg = program.variant_config(cfg, variant)
        if traffic["entry"] != "/process":
            raise ValueError(f"unknown entry {traffic['entry']!r}")
        svc = cfg["service"]
        if svc["storage"] != "local":
            raise ValueError(f"unknown storage {svc['storage']!r}")
        self.attempted = self.failed = 0
        self.kept = None
        self.http = None
        self.tmp = None
        # No proxy, whatever the environment says: the service is local.
        self.opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    # --- set-up -----------------------------------------------------------
    def _write_pool(self) -> None:
        """The pool's recordings, made from the seed on the device, as the
        sensor's file pairs: rx 0 the generated chirps, rx 1 a second draw
        of the same scene (write_upload)."""
        import torch

        dev = torch.device(self.device)
        gen = synth.generator(self.seed, dev)
        t = self.traffic
        device_cfg = program.radar_config(self.cfg).device

        def draw():
            raw, calib, _ = synth.recording(
                self.cfg["device"], self.cfg["algorithm"], self.cfg["frames"],
                t["targets"], gen=gen, device=dev, muted_share=t["muted_share"],
                noise_sigma=t["noise_sigma"], dc_offset=tuple(t["dc_offset"]))
            return raw.cpu().numpy(), calib.cpu().numpy()

        self.pool, self.pool_files = [], []
        for i in range(t["pool"]):
            (raw0, calib), (raw1, _) = draw(), draw()
            base = os.path.join(self.tmp, "pool", str(i), t["filename"])
            os.makedirs(os.path.dirname(base))
            self.pool_files.append(write_upload(base, [raw0, raw1], calib, device_cfg))
            self.pool.append((raw0, calib))

    def _serve(self) -> None:
        from fmcw_radar_processing_tpu_torch.serve.handler import HandlerConfig
        from fmcw_radar_processing_tpu_torch.serve.http_service import RadarHttpService

        svc = self.cfg["service"]
        self.blobs = os.path.join(self.tmp, "blobs")
        workdir = os.path.join(self.tmp, "work")
        os.makedirs(workdir)
        self.http = RadarHttpService(
            HandlerConfig(fdata=self.traffic["filename"], workdir=workdir,
                          storage_spec=f"local:{self.blobs}",
                          pretty_json=svc["pretty_json"], upload=svc["upload"],
                          profile=svc["profile"], device=self.device),
            port=0, host="127.0.0.1")
        if self.variant == "control":
            from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline

            profile = program.radar_config(self.cfg)  # the service's cache key
            self.http.service._pipelines[(profile.device, profile.algorithm)] = RadarPipeline(
                program.radar_config(self.run_cfg), self.traffic["filename"],
                device=self.device, impl=self.run_cfg.get("impl", "auto"))
        self.http.start()
        self.url = self.http.url + self.traffic["entry"].lstrip("/")

    def setup(self) -> None:
        import torch

        program.host_threads(self.cfg)
        self.tmp = tempfile.mkdtemp(prefix="radarbench_service_")
        self._write_pool()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        self._serve()
        for i in range(len(self.pool)):  # every upload once: the shapes warm
            self._call(i)
        program.synchronize(self.device)
        self.work = self._work()

    def _work(self) -> dict:
        """roofline.recording_work of the last call: its columns from the
        detected frames in the range-speed artifact (hop 1)."""
        name = f"{self.traffic['filename']}_range_speed_data.json"
        with open(os.path.join(self.blobs, name)) as f:
            rng = np.asarray(json.load(f)["range"], dtype=np.float64)
        samples = int(np.isfinite(rng).sum()) * self.cfg["device"]["num_chirps_per_frame"]
        cols = max(samples - self.cfg["algorithm"]["stft_window_length"] + 1, 0)
        return roofline.recording_work(self.cfg, self.cfg["frames"], cols)

    def device_info(self) -> dict:
        return program.device_info(self.device, 1)

    # --- the timed path ---------------------------------------------------
    def _call(self, i: int) -> dict:
        """One upload: the pair into the blob storage, then POST /process;
        returns the step-status JSON."""
        xml, raw_bin = self.pool_files[i % len(self.pool)]
        name = self.traffic["filename"]
        shutil.copyfile(xml, os.path.join(self.blobs, name + ".xml"))
        shutil.copyfile(raw_bin, os.path.join(self.blobs, name + ".raw.bin"))
        req = urllib.request.Request(
            self.url, data=json.dumps(self.traffic["request"]).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with self.opener.open(req, timeout=REQUEST_TIMEOUT_S) as r:
            response = json.loads(r.read())
        if response.get("status") != "success":
            self.failed += 1
        return response

    def _keep(self, n: int, response: dict) -> dict:
        """Move the call's five artifacts out of the blob storage (the next
        call writes new files) into a directory of their own."""
        kept = os.path.join(self.tmp, "kept", str(n))
        os.makedirs(kept)
        for name in ref_service.artifact_names(self.traffic["filename"]):
            src = os.path.join(self.blobs, name)
            if os.path.exists(src):
                os.rename(src, os.path.join(kept, name))
        return {"dir": kept, "response": response, "pool": n % len(self.pool)}

    def _loop(self, until) -> int:
        """Calls back to back while ``until(n, elapsed)`` is false; the
        reservoir keeps a sample of the calls' artifacts, and what it drops
        is deleted. Returns the calls made."""
        self._drop_kept()
        self.failed = 0
        res = program.Reservoir(self.traffic["check_items"], self.seed)
        self.kept = res
        t0 = time.perf_counter()
        n, took = 0, []
        while True:
            ta = time.perf_counter()
            response = self._call(n)
            took.append(time.perf_counter() - ta)
            before = dict(res.items)
            res.offer(lambda: self._keep(n, response))
            for k in set(before) - set(res.items):
                shutil.rmtree(before[k]["dir"], ignore_errors=True)
            n += 1
            if until(n, time.perf_counter() - t0):
                print("seconds a call: " + " ".join(f"{t:.3f}" for t in took[:64]),
                      file=sys.stderr)
                return n

    def _drop_kept(self) -> None:
        if self.kept is not None:
            for item in self.kept.items.values():
                shutil.rmtree(item["dir"], ignore_errors=True)
            self.kept = None

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        n = self._loop(lambda n, el: el >= seconds)
        el = time.perf_counter() - t0
        self.attempted = n
        return {"recording_frames_per_s": n * self.cfg["frames"] / el}

    def pre_trace(self) -> dict:
        return {}

    def traced(self, path: str) -> dict:
        items = self.traffic["trace_items"]
        program.synchronize(self.device)
        with tr.profiled(path):
            t0 = time.perf_counter()
            self._loop(lambda n, el: n >= items)
            program.synchronize(self.device)
            window_s = time.perf_counter() - t0
        self.attempted = items
        return {"items": items, "window_s": window_s, "spans": {}, "work": self.work,
                "busy_s": tr.busy_seconds(tr.load_events(path)[0])}

    # --- after the window -------------------------------------------------
    def memory_peak(self) -> int:
        return program.memory_peak(self.device)

    def _stop(self) -> None:
        if self.http is not None:
            self.http.stop()
            self.http = None

    def free(self) -> None:
        self._stop()
        gc.collect()
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        import torch

        on = torch.device(self.device)
        readings: dict = {}
        for _, item in sorted(self.kept.items.items()):
            raw, calib = self.pool[item["pool"]]
            name = self.traffic["filename"]
            r = ref_service.check_service(read_blobs(item["dir"], name), item["response"],
                                          raw, calib, self.cfg, on, name)
            for k, v in r.items():
                readings[k] = v if k not in readings else (
                    readings[k] + v if k.endswith("_faults") else max(readings[k], v))
        return readings

    def close(self) -> None:
        self._stop()
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None
