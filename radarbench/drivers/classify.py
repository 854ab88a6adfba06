"""Spectrogram images classified through the port's HTTP service: ``POST
/classify`` on 127.0.0.1, a real socket, from client threads in a closed
loop, as a dashboard or a sensor fleet posts its groups of sensors'
micro-Doppler spectrograms (human or calf).

Set-up makes the pool of images from the seed: micro-Doppler spectrogram
PNGs at the model's input size from the benchmark's own generator
(radarbench/gen/spectrograms.py), packed ``images_per_request`` at a time
into ``bodies`` JSON bodies ``{"images_b64": [...]}``. It draws the
classifier's weights on the device (radarbench/gen/weights.py), fits the
last Dense to the pool's features as the plain reference computes them
(``fit_readout``: the pool's logits spread with the standard deviation
"logit_std" about 0), writes the weights as the port's classifier
artifact, and starts one ``RadarHttpService`` that loads it, its batcher
at its defaults. Each body is sent once before the window.

In the window ``client_threads`` threads of a client process of their own
(radarbench/gen/clients.py, so that they take no interpreter lock from
the service's threads) each post their next body as soon as the last
answer is in: client c's k-th request sends body (c + k) mod ``bodies``. The rate is the images answered 200 within
the window over its seconds. Every answer of the window (or of the traced
slice) is kept with its body, and after the window every one is held to
the plain float32 reference (reference/vgg16.py), which computes the
pool's logits once.

Traffic keys: "entry" ("/classify"), "client_threads",
"images_per_request", "bodies", "images" (the generator's parameters),
"trace_items" (requests each client sends in the traced slice). The
configuration gives the model ("model", "blocks", "input_shape", "head",
"dtype"), the artifact's "classes", the weights' "bias_std" and
"logit_std", and "control".

The control is the same service with the reference in fp8 in the
model's place (reference/vgg16.py, ``fp8=True``): "control" "compute"
names the dtype.
"""

from __future__ import annotations

import base64
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np

from radarbench import program, roofline
from radarbench import trace as tr
from radarbench.gen import clients, spectrograms, synth, weights
from radarbench.reference import vgg16 as ref_vgg


def decode_png(data: bytes, input_shape) -> np.ndarray:
    """PNG bytes → [H, W, 3] float32 in [0, 1] at the model's size, as the
    service decodes a body (PIL, RGB, bilinear resize, 1/255): the
    reference's input, so that the decode is not what is compared."""
    from PIL import Image

    h, w = input_shape[:2]
    with Image.open(io.BytesIO(data)) as im:
        im = im.convert("RGB").resize((w, h), Image.BILINEAR)
        return np.asarray(im, np.float32) / 255.0


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, out_dir,
                 variant: str = "program"):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.variant = device, variant
        if traffic["entry"] != "/classify":
            raise ValueError(f"unknown entry {traffic['entry']!r}")
        if cfg["model"] != "vgg16" or cfg["dtype"] != "bfloat16":
            raise ValueError(f"the port serves vgg16 in bfloat16, not {cfg['model']!r} "
                             f"in {cfg['dtype']!r}")
        if variant not in ("program", "control"):
            raise ValueError(f"unknown variant {variant!r}")
        if variant == "control" and cfg["control"]["compute"] != "float8_e4m3fn":
            raise ValueError(f"unknown control {cfg['control']!r}")
        self.per = traffic["images_per_request"]
        self.attempted = self.failed = 0
        self.answers: list = []
        self.http = None
        self.tmp = None
        # No proxy, whatever the environment says: the service is local.
        self.opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    # --- set-up -----------------------------------------------------------
    def _images(self) -> None:
        """The pool's PNGs (bodies × images_per_request, made from the seed),
        the images as the service decodes them, and the request bodies."""
        t = self.traffic
        shape = self.cfg["input_shape"]
        self.pngs, _ = spectrograms.spectrogram_pngs(t["bodies"] * self.per, tuple(shape[:2]),
                                                     t["images"], self.seed)
        self.images = np.stack([decode_png(p, shape) for p in self.pngs])
        self.bodies = [json.dumps({"images_b64": [
            base64.b64encode(p).decode() for p in self.pngs[b * self.per:(b + 1) * self.per]]
        }).encode() for b in range(t["bodies"])]
        self.bodies_dir = os.path.join(self.tmp, "bodies")
        os.makedirs(self.bodies_dir)
        for b, body in enumerate(self.bodies):
            with open(os.path.join(self.bodies_dir, f"{b}.json"), "wb") as f:
                f.write(body)

    def _artifact(self) -> str:
        """The weights drawn on the device from the seed, the last Dense
        fitted to the pool by the reference's features, written as the
        port's classifier artifact."""
        import torch

        from fmcw_radar_processing_tpu_torch.models.infer import export_classifier
        from fmcw_radar_processing_tpu_torch.models.params import unflatten_tree

        gen = synth.generator(self.seed, torch.device(self.device))
        self.params = weights.vgg_params(self.cfg["blocks"], self.cfg["input_shape"],
                                         self.cfg["head"], self.cfg["bias_std"], gen,
                                         self.device)
        features = ref_vgg.Vgg16Ref(self.params, self.cfg["blocks"],
                                    self.device).features(self.images)
        self.params["head/out/kernel"], self.params["head/out/bias"] = weights.fit_readout(
            features, self.cfg["logit_std"])
        return export_classifier(os.path.join(self.tmp, "artifact"), self.cfg["model"],
                                 unflatten_tree(self.params), tuple(self.cfg["input_shape"]),
                                 self.cfg["classes"])

    def _serve(self, artifact: str) -> None:
        """One RadarHttpService with the classifier of ``artifact``; for the
        control, the classifier's model is the reference in fp8."""
        from fmcw_radar_processing_tpu_torch.models.infer import SpectrogramClassifier
        from fmcw_radar_processing_tpu_torch.serve.handler import HandlerConfig
        from fmcw_radar_processing_tpu_torch.serve.http_service import RadarHttpService

        workdir = os.path.join(self.tmp, "work")
        os.makedirs(workdir)
        served = {"classifier_artifact": artifact}
        if self.variant == "control":
            clf = SpectrogramClassifier.load(artifact, self.device)
            clf.model = ref_vgg.Vgg16Ref(self.params, self.cfg["blocks"], self.device,
                                         fp8=True)
            served = {"classifier": clf}
        self.http = RadarHttpService(
            HandlerConfig(workdir=workdir, storage_spec=f"local:{self.tmp}/blobs",
                          device=self.device),
            port=0, host="127.0.0.1", **served)
        self.http.start()
        self.url = self.http.url + self.traffic["entry"].lstrip("/")
        self.health_url = self.http.url + "healthz"

    def setup(self) -> None:
        import torch

        program.host_threads(self.cfg)
        self.tmp = tempfile.mkdtemp(prefix="radarbench_classify_")
        self._images()
        artifact = self._artifact()
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        self._serve(artifact)  # loads the artifact and warms every bucket
        for b in range(len(self.bodies)):  # every body once
            status, response = self._post(b)
            if status != 200:
                raise RuntimeError(f"body {b} was answered {status}: {response}")
        program.synchronize(self.device)

    def device_info(self) -> dict:
        return program.device_info(self.device, 1)

    # --- the timed path ---------------------------------------------------
    def _post(self, body: int) -> tuple[int, dict]:
        return clients.post(self.opener, self.url, self.bodies[body])

    def _start_clients(self, seconds: float | None = None, requests: int | None = None):
        """The client process (radarbench/gen/clients.py), started and
        ready: its bodies read, waiting for the word to go."""
        limit = ["--seconds", str(seconds)] if seconds is not None else [
            "--requests", str(requests)]
        proc = subprocess.Popen(
            [sys.executable, clients.__file__, self.url, self.bodies_dir,
             str(self.traffic["client_threads"]), *limit],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        try:
            if proc.stdout.readline().strip() != "ready":
                raise RuntimeError("the client process did not start")
        except BaseException:
            self._end(proc)
            raise
        return proc

    def _run_clients(self, proc) -> dict:
        """Let the started clients go; their result once every one is in."""
        try:
            proc.stdin.write("go\n")
            proc.stdin.close()
            out = proc.stdout.read()
            if proc.wait() != 0:
                raise RuntimeError(f"the client process exited {proc.returncode}")
        finally:
            self._end(proc)
        result = json.loads(out.strip().splitlines()[-1])
        answers = result["answers"]
        self.answers = [(body, status, answer) for _, body, status, answer in answers]
        self.attempted = len(answers)
        self.failed = sum(status != 200 or answer.get("status") != "success"
                          for _, _, status, answer in answers)
        print(f"client process: {len(answers)} requests, {result['cpu_s']:.2f} CPU s in "
              f"{result['seconds']:.2f} s", file=sys.stderr)
        return result

    @staticmethod
    def _end(proc) -> None:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        for f in (proc.stdin, proc.stdout):
            if f is not None and not f.closed:
                f.close()

    def _batching(self) -> dict:
        with self.opener.open(self.health_url, timeout=60) as r:
            return json.loads(r.read())["classify_batching"]

    def window(self, seconds: float) -> dict:
        proc = self._start_clients(seconds=seconds)
        before = self._batching()
        result = self._run_clients(proc)
        after = self._batching()
        answered = sum(self.per for t, _, status, _ in result["answers"]
                       if t <= seconds and status == 200)
        batches = after["batches"] - before["batches"]
        print(f"batches {batches}, images a batch "
              f"{(after['batched_images'] - before['batched_images']) / max(batches, 1):.2f}",
              file=sys.stderr)
        return {"classify_images_per_s": answered / seconds}

    def pre_trace(self) -> dict:
        return {}

    def traced(self, path: str) -> dict:
        proc = self._start_clients(requests=self.traffic["trace_items"])
        before = self._batching()
        program.synchronize(self.device)
        with tr.profiled(path):
            t0 = time.perf_counter()
            result = self._run_clients(proc)
            program.synchronize(self.device)
            window_s = time.perf_counter() - t0
        after = self._batching()
        answered = sum(self.per for _, _, status, _ in result["answers"] if status == 200)
        batches = after["batches"] - before["batches"]
        work = roofline.vgg16_work(self.cfg["input_shape"], self.cfg["blocks"],
                                   self.cfg["head"], answered, batches)
        return {"items": answered, "window_s": window_s, "spans": {}, "work": work,
                "batches": batches,
                "batched_images": after["batched_images"] - before["batched_images"],
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
        """Every kept answer against the reference's logits of the pool."""
        ref = ref_vgg.Vgg16Ref(self.params, self.cfg["blocks"], self.device)
        logits = ref.logits(self.images)
        scale = float(np.std(logits))
        print(f"the pool's logits {logits.min():.4g} to {logits.max():.4g}, standard "
              f"deviation {scale:.4g}; the served score's rounding (6 places) moves a "
              f"logit by {ref_vgg.score_quantum(logits) / scale:.3g} of it at most",
              file=sys.stderr)
        return ref_vgg.check_answers(self.answers, self.cfg["classes"], logits, self.per)

    def close(self) -> None:
        self._stop()
        if self.tmp is not None:
            shutil.rmtree(self.tmp, ignore_errors=True)
            self.tmp = None
