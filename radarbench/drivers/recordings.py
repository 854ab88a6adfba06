"""Recordings back to back, one client, closed loop: the reference's
one-request-at-a-time ``radar_processing`` on a whole recording.

Traffic keys: "entry" (process_recording, the 'no' request, or
process_activity, the 'yes' request), "pool" (distinct recordings made
from the seed, sent in turn), "targets", "muted_share", "noise_sigma",
"dc_offset" (the scene), "trace_items" (recordings in the traced slice),
"check_items" (recordings sampled for the comparison), "filename".

A configuration with "ranks" above 1 runs the recording through
``ShardedRecordingPipeline`` over that many cards (one process a card,
NCCL), and this process is rank 0 (drivers/sharded.py).
"""

from __future__ import annotations

import gc
import sys
import time

from radarbench import program, roofline
from radarbench import trace as tr
from radarbench.gen import synth
from radarbench.reference import compare


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, out_dir,
                 variant: str = "program"):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.variant = device, variant
        self.run_cfg = program.variant_config(cfg, variant)
        self.entry = traffic["entry"]
        if self.entry not in ("process_recording", "process_activity"):
            raise ValueError(f"unknown entry {self.entry!r}")
        self.ranks = int(cfg.get("ranks", 1))
        self.attempted = self.failed = 0
        self.kept = None
        self.pipe = None
        self.sharded = None
        self.out_dir = out_dir

    # --- set-up -----------------------------------------------------------
    def _inputs(self):
        import torch

        dev = torch.device(self.device)
        gen = synth.generator(self.seed, dev)
        t = self.traffic
        pool = []
        for _ in range(t["pool"]):
            raw, calib, _ = synth.recording(
                self.cfg["device"], self.cfg["algorithm"], self.cfg["frames"],
                t["targets"], gen=gen, device=dev, muted_share=t["muted_share"],
                noise_sigma=t["noise_sigma"], dc_offset=tuple(t["dc_offset"]))
            pool.append((raw.cpu().numpy(), calib.cpu().numpy()))
            del raw
        return pool

    def setup(self) -> None:
        import torch

        program.host_threads(self.cfg)
        if self.ranks > 1:
            from radarbench.drivers import sharded

            self.sharded = sharded.Ranks(self.run_cfg, self.traffic, self.seed,
                                         self.ranks, self.out_dir,
                                         torch.device(self.device).type)
            self.sharded.spawn()
        self.pool = self._inputs()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        if self.sharded is not None:
            self.sharded.connect(self.pool)
        else:
            from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline

            self.pipe = RadarPipeline(program.radar_config(self.run_cfg),
                                      self.traffic["filename"], device=self.device,
                                      impl=self.run_cfg.get("impl", "auto"))
        for i in range(len(self.pool)):  # every input once: the shapes warm
            out = self._call(i)
        program.synchronize(self.device)
        self.work = self._work(out)

    def _work(self, out) -> dict:
        f = self.cfg["frames"]
        if self.entry == "process_activity":
            cols = [b.payload["intensity"].shape[1] for b in out]
            return roofline.activity_work(self.cfg, f, cols)
        if self.ranks > 1:
            cols = out["spectrogram_intensity"].shape[1]
        else:
            cols = out.spectrogram_intensity.shape[1]
        return roofline.recording_work(self.cfg, f, cols, self.ranks)

    def device_info(self) -> dict:
        return program.device_info(self.device, self.ranks)

    # --- the timed path ---------------------------------------------------
    def _call(self, i: int, timer=None):
        if self.sharded is not None:
            return self.sharded.process(i % len(self.pool))
        raw, calib = self.pool[i % len(self.pool)]
        if self.entry == "process_recording":
            return self.pipe.process_recording(raw, calib, timer=timer)
        return self.pipe.process_activity(raw, calib)

    def _keep(self, out):
        """What the comparison reads of one call's outputs, as host NumPy."""
        if self.entry == "process_activity":
            return [{"batch": b.batch, "start_frame": b.start_frame,
                     "end_frame": b.end_frame, "filename": b.filename,
                     "payload": b.payload} for b in out]
        if self.ranks > 1:
            kept = {"payloads": {"spectrogram_data.json": out["payload"]},
                    "waterfall": out["waterfall"], "range": out["range"][0],
                    "speed": out["speed"][0], "detected": out["detected"],
                    "db": out["spectrogram_db"]}
        else:
            kept = {"payloads": out.payloads, "detected": out.detected,
                    "strength": out.target_strength[0], "db": out.spectrogram_psd_db}
        return program.lower_outputs(kept, self.cfg, self.variant)

    def _loop(self, until, timer=None) -> int:
        """Calls back to back while ``until(n, elapsed)`` is false; the
        reservoir keeps a sample of the outputs. Returns the calls made."""
        res = program.Reservoir(self.traffic["check_items"], self.seed)
        self.kept = res
        t0 = time.perf_counter()
        n, took = 0, []
        while True:
            ta = time.perf_counter()
            out = self._call(n, timer)
            took.append(time.perf_counter() - ta)
            res.offer(lambda: self._keep(out))
            del out
            n += 1
            if until(n, time.perf_counter() - t0):
                print("seconds a call: " + " ".join(f"{t:.3f}" for t in took[:64]),
                      file=sys.stderr)
                return n

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        n = self._loop(lambda n, el: el >= seconds)
        el = time.perf_counter() - t0
        self.attempted = n
        if self.sharded is not None:
            self.sharded.stop()
        return {"recording_frames_per_s": n * self.cfg["frames"] / el}

    def pre_trace(self) -> dict:
        return {}

    def traced(self, path: str) -> dict:
        from fmcw_radar_processing_tpu_torch.utils.observe import StageTimer

        items = self.traffic["trace_items"]
        timer = StageTimer() if self.entry == "process_recording" else None
        program.synchronize(self.device)
        if self.sharded is not None:
            self.sharded.trace_begin()
        with tr.profiled(path):
            t0 = time.perf_counter()
            self._loop(lambda n, el: n >= items, timer)
            program.synchronize(self.device)
            window_s = time.perf_counter() - t0
        busy = tr.busy_seconds(tr.load_events(path)[0])
        if self.sharded is not None:  # each rank's own slice, averaged
            self.sharded.trace_end()
            self.sharded.stop(busy, window_s)
            busy = sum(self.sharded.busy) / self.ranks
            window_s = sum(self.sharded.windows) / self.ranks
        self.attempted = items
        spans = ({k: r.seconds for k, r in timer.records.items()}
                 if timer is not None else {})
        return {"items": items, "window_s": window_s, "spans": spans,
                "work": self.work, "busy_s": busy}

    # --- after the window -------------------------------------------------
    def memory_peak(self) -> int:
        if self.sharded is not None:
            return self.sharded.memory_peak
        return program.memory_peak(self.device)

    def free(self) -> None:
        self.pipe = None
        if self.sharded is not None:
            self.sharded.pipe = None
        gc.collect()
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        import torch

        on = torch.device(self.device)
        readings: dict = {}
        for i, out in sorted(self.kept.items.items()):
            raw, calib = self.pool[i % len(self.pool)]
            if self.entry == "process_activity":
                r = compare.check_activity(out, raw, calib, self.cfg, on,
                                           self.traffic["filename"])
            else:
                r = compare.check_recording(out, raw, calib, self.cfg, on,
                                            self.traffic["filename"],
                                            sharded=self.ranks > 1)
            for k, v in r.items():
                readings[k] = v if k not in readings else (
                    readings[k] + v if k.endswith("_faults") else max(readings[k], v))
        return readings

    def close(self) -> None:
        if self.sharded is not None:
            self.sharded.close()
