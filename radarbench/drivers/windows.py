"""Streamed windows, one client, closed loop: a fleet's channels fed to
``StreamingProcessor.process_window`` window after window, each window's
results read back to the host before the next is sent.

Traffic keys: "pool_windows" (distinct windows per channel made from the
seed: one continuous recording per channel, cut into windows and sent in
order, round and round), "channel_targets" (one list of targets per
channel), "muted_share" (exact in every window), "noise_sigma",
"dc_offset", "enqueue_items" (windows timed for the dispatch cost before
the traced slice), "trace_items" (windows in the traced slice),
"check_items" (windows sampled for the comparison).

A window is timed from its host NumPy inputs to its results on the host:
psd_db, detected, range, speed, waterfall (and strength and col_count,
which the comparison reads). As a fleet's client would, the driver reads
them into host buffers of its own, pinned on a card, made at the shape's
first window in set-up and reused by every window after it.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np

from radarbench import program, roofline
from radarbench import trace as tr
from radarbench.gen import synth
from radarbench.reference import compare

READ_BACK = ("psd_db", "detected", "range", "speed", "waterfall", "strength", "col_count")


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, out_dir,
                 variant: str = "program"):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.variant = device, variant
        self.run_cfg = program.variant_config(cfg, variant)
        self.attempted = self.failed = 0
        self.kept = None
        self.proc = None
        self.n = 0  # windows fed since the stream started
        self.host, self.views = {}, {}  # the client's result buffers, and their arrays

    def setup(self) -> None:
        import torch

        from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import make_frame_chain
        from fmcw_radar_processing_tpu_torch.pipeline.streaming import StreamingProcessor

        program.host_threads(self.cfg)
        cfg, t = self.cfg, self.traffic
        c, f, pool = cfg["channels"], cfg["window_frames"], t["pool_windows"]
        if len(t["channel_targets"]) != c:
            raise ValueError(f"{len(t['channel_targets'])} channel target lists for {c} channels")
        dev = torch.device(self.device)
        gen = synth.generator(self.seed, dev)
        raws, cals = [], []
        for targets in t["channel_targets"]:
            raw, calib, _ = synth.recording(
                cfg["device"], cfg["algorithm"], pool * f, targets, gen=gen, device=dev,
                muted_share=t["muted_share"], mute_block=f, noise_sigma=t["noise_sigma"],
                dc_offset=tuple(t["dc_offset"]))
            raws.append(raw.reshape(pool, f, *raw.shape[1:]).cpu().numpy())
            cals.append(calib.cpu().numpy())
            del raw
        self.pool_raw = np.stack(raws)  # [C, P, F, PN, 2·NTS]
        self.calib = np.stack(cals)  # [C, NTS, 2]
        self.windows = [np.ascontiguousarray(self.pool_raw[:, j]) for j in range(pool)]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        rc = program.radar_config(self.run_cfg)
        self.proc = StreamingProcessor(rc, c, f, device=dev, nfft=cfg["nfft"],
                                       db_mode=cfg["db_mode"])
        if "chain_impl" in self.run_cfg:  # the control's chain
            self.proc._chain = make_frame_chain(rc, self.proc.device,
                                                impl=self.run_cfg["chain_impl"])
        for j in range(pool):  # the one shape, every input once
            self._window(j)
        self.proc.reset()
        self.n = 0
        self.work = roofline.stream_window_work(cfg)

    def device_info(self) -> dict:
        return program.device_info(self.device, 1)

    def _window(self, i: int) -> dict:
        """Window ``i`` of the stream: sent from the host, its results read
        back to the host."""
        res = self.proc.process_window(self.windows[i % len(self.windows)], self.calib)
        return self._read_back(res)

    def _read_back(self, res) -> dict:
        """The results into the client's own host buffers, made at the first
        window of a shape (pinned when on a card) and reused by every later
        one: the copies are waited for; the arrays are views of the buffers."""
        import torch

        for k in READ_BACK:
            t = getattr(res, k)
            b = self.host.get(k)
            if b is None or b.shape != t.shape or b.dtype != t.dtype:
                b = self.host[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
                self.views[k] = b.numpy()
            b.copy_(t, non_blocking=True)
        program.synchronize(self.device)
        return self.views

    def _loop(self, until) -> list[float]:
        """Windows back to back until ``until(count, elapsed)``; returns each
        window's latency in ms. The reservoir samples windows to compare."""
        res = self.kept = program.Reservoir(self.traffic["check_items"], self.seed)
        res.n = self.n
        lat = []
        t0 = time.perf_counter()
        while True:
            ta = time.perf_counter()
            out = self._window(self.n)
            tb = time.perf_counter()
            lat.append(1e3 * (tb - ta))
            res.offer(lambda: {k: v.copy() for k, v in out.items()})
            self.n += 1
            if until(len(lat), tb - t0):
                return lat

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        lat = self._loop(lambda n, el: el >= seconds)
        el = time.perf_counter() - t0
        self.attempted = len(lat)
        tenths = np.array_split(np.asarray(lat), 10)
        print("window latency median by tenth of the window, ms: "
              + " ".join(f"{np.median(t):.2f}" for t in tenths if len(t)), file=sys.stderr)
        c, f = self.cfg["channels"], self.cfg["window_frames"]
        return {"stream_frames_per_s": len(lat) * c * f / el,
                "stream_window_p95_ms": float(np.percentile(lat, 95))}

    def pre_trace(self) -> dict:
        """The dispatch cost: host time until process_window returns, with
        no sync, over ``enqueue_items`` windows (read back after)."""
        ms = []
        for _ in range(self.traffic["enqueue_items"]):
            ta = time.perf_counter()
            res = self.proc.process_window(self.windows[self.n % len(self.windows)],
                                           self.calib)
            ms.append(1e3 * (time.perf_counter() - ta))
            self._read_back(res)
            self.n += 1
        return {"enqueue_ms": ms}

    def traced(self, path: str) -> dict:
        items = self.traffic["trace_items"]
        program.synchronize(self.device)
        with tr.profiled(path):
            t0 = time.perf_counter()
            self._loop(lambda n, el: n >= items)
            program.synchronize(self.device)
            window_s = time.perf_counter() - t0
        self.attempted = items
        return {"items": items, "window_s": window_s, "spans": {}, "work": self.work}

    def memory_peak(self) -> int:
        return program.memory_peak(self.device)

    def free(self) -> None:
        self.proc = None
        gc.collect()
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        import torch

        return compare.check_stream_windows(self.kept.items, self.pool_raw, self.calib,
                                            self.cfg, torch.device(self.device))

    def close(self) -> None:
        pass
