"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``fmcw_radar_processing_tpu_torch/csrc``
and holds each against its plain PyTorch version, timing both: K1a (the
bf16x3 profile on the tensor cores, also held to the exact profile at
100 dB), K1c (one bf16 pass on the tensor cores, at 45 dB), K1b (the exact
profile), K6 (the range FFT stored too) and K7 (the
fused peak search, T = 1 and 3) at the shapes of the production recording
path (65,536 frames of 16 chirps × 64 samples), K2-K3 there at STFT nfft
256, K3 and K5b at nfft 512 (K3's 64-column tiles), K4a/K4b at the
fidelity profile's shape (1,024 frames, nfft 16,384)
and at 65,536 columns of nfft 65,536, where offsets pass 2^31. Then it
drives the main paths, each with the launch counters reset just before
and read just after: ``RadarPipeline.process_recording`` under the
production profile on a 65,536-frame synthetic recording with the default
impl (K1a, K2, K3) and with impl "pallas" (K6, K7, K2, K3), the recompute
export ``spectrogram(recompute=True)`` on that run's packed signal (K5a,
K5b, bit-equal to K2/K3) and on the same signal at nfft 1,000 (nb_pad 504:
the bin-blocked recompute pair psd_tmax_tiled/db_rescale_recompute_tiled,
bit-equal to K4a/K4b), the fidelity profile on a 1,024-frame recording
(K1a, K4a, K4b) and that recording with impl "pallas_profile" (K1b),
checking the detections against the injected targets. The production
recording also runs with impl "pallas_profile_bf16" (K1c, K2, K3), held
to the exact impl "pallas_profile"; with the plain formulations "fused",
"xla" and "fused_bf16" (first 256 frames against the CPU plain path); and
with ``stft_impl="xla"`` (the plain export: a float32 dB map, the
intensity within the display band of the kernels'). A 256-frame
production recording at ``stft_hop=4`` (plain PyTorch after the frame
chain, as the JAX package's XLA branch) is held to the CPU plain path.
The service answers production and default-profile requests,
full-recording ("no") and activity ("yes"). Then the persistent service
path at full size: [stream] the streaming processor at bench.py's
5_streaming_8ch shape (production, 8 channels, 256-frame windows, K1a
counted), against the CPU plain path and its own window split, timed per
window; [classify] VGG16 at 224×224×3 from seeded weights, bf16 against
float32, timed at batch 1, 8 and 64; [service] the HTTP service with that
classifier: /process, the dashboard's manifest, /classify alone, eight at
once (coalesced) and at 1, 8 and 64 images. It prints a kernel table and a
device line as JSON. Each kernel row has its time (``ms``: the first of
two timed runs in each turn, right after its plain version; the second,
right after itself, is ``ms_second_in_turn``), its plain version's time,
its launches on the path that drives it, and its bound: the larger
of the bytes it must move over 3.35 TB/s and its operations over the peak
of their type (989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32),
the published H100 SXM figures. Any failed check raises, so the exit code
is non-zero. There is no CPU path: without a CUDA device it exits at once.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FRAMES = 65_536
FIDELITY_FRAMES = 1_024  # nfft 16,384: bench.py's 6_fidelity_stft_nextpow2
SEED = 20261016
MUTED_SHARE = 0.10
REPS = 11
WIDE_REPS = 5  # timing runs at the 65,536-column, nfft 65,536 shape
# [stream]: bench.py's 5_streaming_8ch (production profile, nfft 256).
STREAM_CHANNELS = 8
STREAM_WINDOW = 256  # frames per window and channel
STREAM_WINDOWS = 4  # windows of the 1,024-frame recording
STREAM_TIMED = 20  # timed steady-state windows per mode and input
VGG_SHAPE = (224, 224, 3)
VGG_BATCHES = (1, 8, 64)
# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# operations/s by type.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "f32": 67e12}
NO_LIBRARY = "no single PyTorch call computes this function"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_turns(fns: dict, reps: int = REPS,
               second: dict | None = None) -> dict[str, float]:
    """Median CUDA-event milliseconds of each callable, run in turns after
    a warmup of each. In its turn a callable runs twice, timed both times.
    The first run, right after the previous callable, is its time (the
    reading of every kernel time this script has reported); it also pays
    for what that one left behind (freed allocations, cold translations).
    The second run, right after itself, goes to ``second``."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times: dict[str, list[float]] = {name: [] for name in fns}
    seconds: dict[str, list[float]] = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            for into in (times, seconds):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                stop.record()
                stop.synchronize()
                into[name].append(start.elapsed_time(stop))
    if second is not None:
        second.update({name: statistics.median(t) for name, t in seconds.items()})
    return {name: statistics.median(t) for name, t in times.items()}


def time_pair(kernel, plain, reps: int = REPS) -> tuple[float, float, float]:
    """Median CUDA-event milliseconds of a kernel and its plain version, in
    turns, and the kernel's second-in-turn median (see time_turns)."""
    second: dict[str, float] = {}
    t = time_turns({"kernel": kernel, "plain": plain}, reps, second)
    return t["kernel"], t["plain"], second["kernel"]


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes
    over HBM_BYTES_S and the operations over the peak of their kind."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def psd_ops(columns: int, nb_pad: int) -> float:
    """float32 operations of the PSD of ``columns`` valid windows: two
    20-tap dot products per bin, then the square-add."""
    return float(columns) * nb_pad * (2 * 2 * 20 + 3)


def db_ops(t_pad: int, nb_pad: int, num_bins: int = 1024) -> float:
    """float32 operations of the dB map (clamp, divide, log, scale, floor)
    and of the two-tap interpolation (a multiply and an FMA) per column."""
    return float(t_pad) * (5 * nb_pad + 3 * num_bins)


def snr_db(got, want) -> float:
    got = torch.as_tensor(got, dtype=torch.float64)
    want = torch.as_tensor(want, dtype=torch.float64)
    err = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    return -20.0 * float(np.log10(max(err, 1e-30)))


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    e = torch.floor(torch.log2(x.abs().clamp_min(1e-30)))
    return torch.exp2(e - 7)


def k4_check(stc, db_floor, sig, count, op, int_dtype, last_cols=None):
    """Run K4a and K4b on the whole signal (float32 dB store) and hold them
    against their plain versions: on every column, or, with ``last_cols``,
    on the last columns only, the plain values then computed from the
    matching sub-signal and the kernels' own gmax (every column depends only
    on its window and gmax). Returns (errors, timing operands)."""
    nb = op.num_bins
    nb_pad = -(-nb // 8) * 8
    t_pad = -(-(sig.shape[0] - 19) // stc.PSD_TILE) * stc.PSD_TILE
    nv = count - 19
    a2 = torch.as_tensor(stc._folded_operator(op, 8), device=sig.device)
    p, tmax = stc.psd_phase1_tiled(sig, nv, a2, nb_pad, t_pad)
    gmax = tmax.amax()
    db, out = stc.db_rescale_tiled(p, gmax, nb, 1024, torch.float32, int_dtype)
    t0 = 0 if last_cols is None else t_pad - last_cols
    p_ref, tmax_ref = stc.psd_phase1_ref(sig[t0:], nv - t0, a2, nb_pad, t_pad - t0)
    perr = (p[:, t0:] - p_ref).abs()
    ok = bool((perr <= 1e-10 + 1e-4 * p_ref.abs()).all())
    if last_cols is None:
        ok &= bool((gmax - tmax_ref.amax()).abs() <= 1e-5 * tmax_ref.amax())
    p_err = float(perr.max())
    del perr, p_ref
    db_ref, out_ref = stc.db_rescale_ref(p[:, t0:].contiguous(), gmax, nb, 1024,
                                         torch.float32, int_dtype)
    db_k, out_k = db[:, t0:], out[:, t0:]
    ok &= bool(torch.equal(db_k == db_floor, db_ref == db_floor))
    band = db_ref > -120
    d = (db_k - db_ref).abs()
    db_err = float(d[band].max())
    ok &= db_err <= 1e-3
    if int_dtype == torch.int8:
        d = (out_k.int() - out_ref.int()).abs()
        ok &= bool((d <= 1).all())
    elif int_dtype == torch.bfloat16:
        d = (out_k.float() - out_ref.float()).abs()
        ok &= bool((d <= bf16_ulp(out_ref.float())).all())
    else:
        d = (out_k - out_ref).abs()
        ok &= bool((d <= 2e-3).all())
    int_err = float(d.max())
    tol = {torch.float32: "2e-3 dB", torch.bfloat16: "one bf16 ulp",
           torch.int8: "one code"}[int_dtype]
    where = "all" if last_cols is None else f"the last {last_cols}"
    print(f"[parity] K4 nfft {op.nfft} L={sig.shape[0]} nb_pad={nb_pad} "
          f"t_pad={t_pad} ({where} columns, intensity {str(int_dtype)[6:]}): "
          f"p max_abs_err {p_err:.6g} (tol 1e-10 + 1e-4·|ref|; gmax "
          f"{float(gmax):.6g}); db {db_err:.6g} above -120 dB (tol 1e-3); "
          f"intensity {int_err:.6g} (tol {tol}); floor masks equal "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"K4 parity at nfft {op.nfft} ({int_dtype})")
    return (p_err, db_err, int_err), (sig, nv, a2, nb_pad, t_pad, p, gmax)


def k4_times(stc, nb: int, operands, reps: int):
    """Median ms of K4a and of K4b (float32 stores), each in turns with its
    plain version: ((K4a, plain, K4a second in turn), (K4b, ...))."""
    sig, nv, a2, nb_pad, t_pad, p, gmax = operands
    f32 = torch.float32
    k4a = time_pair(lambda: stc.psd_phase1_tiled(sig, nv, a2, nb_pad, t_pad),
                    lambda: stc.psd_phase1_ref(sig, nv, a2, nb_pad, t_pad), reps)
    k4b = time_pair(lambda: stc.db_rescale_tiled(p, gmax, nb, 1024, f32, f32),
                    lambda: stc.db_rescale_ref(p, gmax, nb, 1024, f32, f32), reps)
    return k4a, k4b


def k3_wide_check(stc, db_floor, sig, nv, op) -> None:
    """K3 where its 128-column tiles no longer fit a block's shared memory
    (nb_pad above 208, here nfft 512: nb_pad 264 with the float32 dB map,
    272 with the bf16 one), so it runs 64-column tiles. Every store dtype
    against the plain version; with the float32 dB map, K5b bit-equal."""
    nb = op.num_bins
    t_pad = -(-(sig.shape[0] - 19) // stc.PSD_TILE) * stc.PSD_TILE
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    f32, bf16 = torch.float32, torch.bfloat16
    for db_dtype, int_dtype in ((f32, f32), (f32, bf16), (f32, torch.int8),
                                (bf16, bf16)):
        align = 16 if db_dtype == bf16 else 8
        nb_pad = -(-nb // align) * align
        check(2 * nb_pad * 128 * 4 + 1024 * 12 > optin,
              f"nb_pad {nb_pad} takes K3's 64-column tiles")
        a2 = torch.as_tensor(stc._folded_operator(op, align), device=sig.device)
        p, tmax = stc.psd_phase1(sig, nv, a2, nb_pad, t_pad)
        gmax = tmax.amax()
        db, out = stc.db_rescale(p, gmax, nb, 1024, db_dtype, int_dtype)
        db_ref, out_ref = stc.db_rescale_ref(p, gmax, nb, 1024, db_dtype, int_dtype)
        ok = bool(torch.equal(db == db_floor, db_ref == db_floor))
        d = (db.float() - db_ref.float()).abs()
        ok &= bool((d <= (2e-3 if db_dtype == f32
                          else bf16_ulp(db_ref.float()))).all())
        db_err = float(d.max())
        if int_dtype == torch.int8:
            d = (out.int() - out_ref.int()).abs()
            ok &= bool((d <= 1).all())
        elif int_dtype == bf16:
            d = (out.float() - out_ref.float()).abs()
            ok &= bool((d <= bf16_ulp(out_ref.float())).all())
        else:
            d = (out - out_ref).abs()
            ok &= bool((d <= 2e-3).all())
        int_err = float(d.max())
        del d, db_ref, out_ref, p
        bit = "n/a (K5b stores a float32 dB map only)"
        if db_dtype == f32:
            tmax_r = stc.psd_tmax(sig, nv, a2, nb_pad, t_pad)
            db_r, out_r = stc.db_rescale_recompute(sig, nv, a2, tmax_r.amax(), nb,
                                                   1024, t_pad, int_dtype)
            same = [bool(torch.equal(tmax_r, tmax)), bool(torch.equal(db_r, db)),
                    bool(torch.equal(out_r, out))]
            ok &= all(same)
            bit = str(same)
            del db_r, out_r
        tol = {f32: "2e-3", bf16: "one bf16 ulp", torch.int8: "one code"}
        print(f"[parity] K3 db_rescale 64-column tiles nfft {op.nfft} "
              f"nb_pad={nb_pad} t_pad={t_pad} stores {str(db_dtype)[6:]}/"
              f"{str(int_dtype)[6:]}: db max_abs_err {db_err:.6g} (tol "
              f"{tol[db_dtype]}), intensity {int_err:.6g} (tol {tol[int_dtype]}); "
              f"tmax, db, intensity bit-equal to K5b {bit} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"K3 parity at nb_pad {nb_pad} ({db_dtype}, {int_dtype})")
        del db, out
    torch.cuda.empty_cache()


def recompute_check(stc, db_floor, sig, nv, a2, nb, t_pad, tiled: bool):
    """The recompute pair on ``sig`` in every intensity dtype: K5a/K5b, or
    with ``tiled`` psd_tmax_tiled/db_rescale_recompute_tiled. Its tmax, db
    and intensity bit-equal to the materializing pair's (K2 → K3, or
    K4a → K4b; float32 dB map), each within K2/K3's bounds of its plain
    version. Returns (tmax error, float32 db and intensity error)."""
    nb_pad = a2.shape[0] // 2
    if tiled:
        names = ("K4a/K4b", "tiled recompute")
        phase1, phase2 = stc.psd_phase1_tiled, stc.db_rescale_tiled
        tmax_fn, rescale_fn = stc.psd_tmax_tiled, stc.db_rescale_recompute_tiled
    else:
        names = ("K2/K3", "K5a/K5b")
        phase1, phase2 = stc.psd_phase1, stc.db_rescale
        tmax_fn, rescale_fn = stc.psd_tmax, stc.db_rescale_recompute
    tmax_err = rescale_err = 0.0
    for int_dtype in (torch.float32, torch.bfloat16, torch.int8):
        p, tmax = phase1(sig, nv, a2, nb_pad, t_pad)
        db, out = phase2(p, tmax.amax(), nb, 1024, torch.float32, int_dtype)
        del p
        tmax_r = tmax_fn(sig, nv, a2, nb_pad, t_pad)
        gmax_r = tmax_r.amax()
        db_r, out_r = rescale_fn(sig, nv, a2, gmax_r, nb, 1024, t_pad, int_dtype)
        bit = [bool(torch.equal(tmax_r, tmax)), bool(torch.equal(db_r, db)),
               bool(torch.equal(out_r, out))]
        del db, out
        # One max per 1,024-column tile (the tiled kernel's are cut per bin
        # block too, bin block major).
        tmax_cols = tmax_r.reshape(-1, t_pad // stc.PSD_TILE).amax(0)
        tmax_ref = stc.psd_tmax_ref(sig, nv, a2, nb_pad, t_pad)
        d = (tmax_cols - tmax_ref).abs()
        ok = bool((d <= 1e-5 * tmax_ref.abs()).all())
        t_err = float(d.max())
        tmax_err = max(tmax_err, t_err)
        db_ref, out_ref = stc.db_rescale_recompute_ref(sig, nv, a2, gmax_r, nb,
                                                       1024, t_pad, int_dtype)
        ok &= bool(torch.equal(db_r == db_floor, db_ref == db_floor))
        d = (db_r - db_ref).abs()
        db_err = float(d[db_ref > -120].max())
        ok &= db_err <= 1e-3
        if int_dtype == torch.int8:
            d = (out_r.int() - out_ref.int()).abs()
            ok &= bool((d <= 1).all())
        elif int_dtype == torch.bfloat16:
            d = (out_r.float() - out_ref.float()).abs()
            ok &= bool((d <= bf16_ulp(out_ref.float())).all())
        else:
            d = (out_r - out_ref).abs()
            ok &= bool((d <= 2e-3).all())
        int_err = float(d.max())
        if int_dtype == torch.float32:
            rescale_err = max(db_err, int_err)
        tol = {torch.float32: "2e-3 dB", torch.bfloat16: "one bf16 ulp",
               torch.int8: "one code"}[int_dtype]
        print(f"[parity] {names[1]} L={sig.shape[0]} nb_pad={nb_pad} intensity "
              f"{str(int_dtype)[6:]}: tmax, db, intensity bit-equal to "
              f"{names[0]} {bit}; vs plain: tmax {t_err:.6g} (tol "
              f"1e-5·|ref|), db {db_err:.6g} above -120 dB (tol 1e-3), "
              f"intensity {int_err:.6g} (tol {tol}), floor masks equal "
              f"{'ok' if ok and all(bit) else 'FAIL'}")
        check(ok and all(bit), f"{names[1]} parity ({int_dtype})")
        del db_r, out_r, db_ref, out_ref, d, tmax_ref
    torch.cuda.empty_cache()
    return tmax_err, rescale_err


def held_to_exact(what: str, got, exact, max_share: float) -> None:
    """A production run's detections against the exact chain's (impl
    "pallas_profile") on the same recording: at most ``max_share`` of the
    frames detected differently, target ranges exact on the frames both
    detect."""
    diff = int((got.detected != exact.detected).sum())
    both = got.detected & exact.detected
    n = got.detected.shape[0]
    check(diff <= max_share * n, f"{what}: {diff} of {n} frames detected "
          f"differently from the exact chain (tol {max_share:.1%})")
    check(np.array_equal(got.target_range[:, both], exact.target_range[:, both],
                         equal_nan=True),
          f"{what}: ranges equal the exact chain's on the {int(both.sum())} "
          "frames both detect")
    print(f"[{what}] {diff} of {n} frames detected differently from the exact "
          f"chain (tol {max_share:.1%}); ranges equal on the {int(both.sum())} "
          "frames both detect")


def serve_no(svc, work: str, want_range, what: str) -> None:
    """One full-recording request: success, the four payloads and the PNG
    written, the injected range in every detected frame."""
    res = svc.main({"processAnimalActivity": "no"})
    check(res["status"] == "success", f"{what}: {res}")
    for name in ("spectrogram_data.json", "radar_data_range_fft_data.json",
                 "radar_data_range_speed_data.json", "radar_data_fft_data.json",
                 "spectrogram.png"):
        check(os.path.exists(os.path.join(work, name)), f"{what}: {name} written")
    with open(os.path.join(work, "radar_data_range_speed_data.json")) as fh:
        rs = json.load(fh)
    # (T, F) with T = 1 encodes as a flat row (jsonencode rules).
    ranges = [v for v in np.ravel(np.array(rs["range"], dtype=object))
              if v is not None]
    check(len(ranges) > 0 and all(v == float(want_range) for v in ranges),
          f"{what}: ranges = {want_range}")


def serve_yes(svc, work: str, detected: np.ndarray, pn: int, what: str) -> None:
    """One activity request on a 256-frame recording: three batch JSONs,
    named and numbered as the JAX service names them, each with a finite
    [1024, 16·detected − 19] intensity."""
    res = svc.main({"processAnimalActivity": "yes"})
    check(res["status"] == "success", f"{what}: {res}")
    names = [f"radar_data_spectrogram_batch_{b}.json" for b in (1, 2, 3)]
    check(res["steps"][1]["artifacts"] == names, f"{what}: {res['steps'][1]}")
    for b, name in enumerate(names):
        with open(os.path.join(work, name)) as fh:
            payload = json.load(fh)
        start, end = 100 * b + 1, min(100 * (b + 1), len(detected))
        check((payload["title"], payload["start_frame"], payload["end_frame"],
               payload["filename_base"]) == (f"Spectrogram - Batch {b + 1}",
                                             start, end, "radar_data"),
              f"{what}: {name} header")
        intensity = np.array(payload["intensity"], dtype=np.float64)
        n_valid = int(detected[start - 1 : end].sum()) * pn - 19
        check(intensity.shape == (1024, n_valid)
              and bool(np.isfinite(intensity).all()),
              f"{what}: {name} intensity finite, shape (1024, {n_valid})")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def count_syncs(fn) -> int:
    """Host synchronizations ``fn`` makes, as torch's sync debug mode
    reports them (a prototype: it may miss some)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def stream_phase(dev, cfg, lib, channels=STREAM_CHANNELS,
                 window=STREAM_WINDOW, windows=STREAM_WINDOWS,
                 timed=STREAM_TIMED) -> dict:
    """[stream] The streaming processor at bench.py's 5_streaming_8ch shape
    (production profile, 8 channels, 256-frame windows, nfft 256), fed 4
    windows of a 1,024-frame recording per channel: counted launches, the
    first window against the CPU plain path, window-split invariance,
    injected targets, and the steady-state window latency."""
    from fmcw_radar_processing_tpu_torch import SyntheticTarget, synthesize_recording
    from fmcw_radar_processing_tpu_torch.dsp.stft import DB_FLOOR
    from fmcw_radar_processing_tpu_torch.pipeline.streaming import StreamingProcessor
    from fmcw_radar_processing_tpu_torch.utils.cplx import to_pair

    print(f"[stream] card: {card_line()}")
    frames = window * windows
    rng = np.random.default_rng(SEED + 3)
    raws, cals, present, want_rng, want_spd = [], [], [], [], []
    step = np.float32(-cfg.derived.fd_per_bin * cfg.derived.hz_to_mps)
    for c in range(channels):
        tgt = SyntheticTarget(range_m=4.5 + 1.6 * c,
                              doppler_bin_offset=(3, -2, 1, -4, 2, -1, 4, -3)[c % 8],
                              amplitude=4.0)
        pres = rng.random(frames) >= MUTED_SHARE
        rec = synthesize_recording(cfg, frames, (tgt,), seed=SEED + 10 + c,
                                   target_present=pres)
        raws.append(to_pair(rec.rx1()).reshape(frames, cfg.pn, 2 * cfg.nts))
        cals.append(to_pair(rec.calib_vector(0, cfg.nts)))
        present.append(pres)
        want_rng.append(np.float32(tgt.range_bin(cfg))
                        * np.float32(cfg.derived.dist_per_bin))
        want_spd.append(np.float32(tgt.doppler_bin_offset) * step)
    raw, cal, present = np.stack(raws), np.stack(cals), np.stack(present)

    # The path, counted: 4 windows × 8 channels from host arrays.
    sp = StreamingProcessor(cfg, channels, window, dev)
    torch.cuda.synchronize()
    lib.reset_launches()
    got = [sp.process_window(raw[:, i * window:(i + 1) * window], cal)
           for i in range(windows)]
    torch.cuda.synchronize()
    launches = dict(lib.LAUNCHES)
    print(f"[stream] launches over {windows} windows of {channels} channels: "
          f"{launches}")
    check(launches["fast_time_profile_b3"] == channels * windows,
          f"K1a launched once per channel and window ({channels * windows})")
    check(sum(launches.values()) == launches["fast_time_profile_b3"],
          "only K1a on the streaming path")

    # Detections, ranges and speeds against the injected targets.
    n_det = 0
    for i, r in enumerate(got):
        sl = slice(i * window, (i + 1) * window)
        det = r.detected.cpu().numpy()
        check(np.array_equal(det, present[:, sl]), f"window {i}: detected frames")
        rg, sd = r.range.cpu().numpy()[:, 0], r.speed.cpu().numpy()[:, 0]
        for c in range(channels):
            check(np.all(rg[c, det[c]] == want_rng[c])
                  and np.all(np.isnan(rg[c, ~det[c]]))
                  and np.all(sd[c, det[c]] == want_spd[c]),
                  f"window {i} channel {c}: range {want_rng[c]} m, speed "
                  f"{want_spd[c]} m/s")
        n_det += int(det.sum())
    # Seamless columns: over the windows, Σ valid samples − (W − 1) each.
    cols = sum(r.col_count.cpu().numpy().astype(np.int64) for r in got)
    check(np.array_equal(cols, present.sum(1) * cfg.pn - 19),
          "columns per channel = detected samples - 19")
    print(f"[stream] ranges and speeds equal the injected targets in all "
          f"{n_det} detected frames of {channels * frames}")

    # The first window against the port's CPU plain path on the same input
    # (its chain's "auto" is the exact profile there, K1a's bf16x3 here: the
    # waterfall is held to 100 dB, detections, ranges and speeds exactly).
    want = StreamingProcessor(cfg, channels, window, "cpu").process_window(
        raw[:, :window], cal)
    g0 = got[0]
    check(torch.equal(g0.detected.cpu(), want.detected)
          and torch.equal(g0.col_count.cpu(), want.col_count), "first window: "
          "detected, col_count exact")
    w_snr = snr_db(g0.waterfall.cpu(), want.waterfall)
    check(w_snr >= 100.0, f"first window: waterfall {w_snr:.2f} dB >= 100 dB")
    for name, atol in (("range", 0.0), ("speed", 1e-7)):
        a, b = getattr(g0, name).cpu(), getattr(want, name)
        check(torch.equal(a.isnan(), b.isnan())
              and torch.allclose(a, b, rtol=1e-6, atol=atol, equal_nan=True),
              f"first window: {name} rtol 1e-6")
    p, pw = g0.psd.cpu(), want.psd
    scale = pw.amax(dim=(-2, -1), keepdim=True)
    psd_err = float(((p - pw).abs() / scale).max())
    check(psd_err <= 1e-4, "first window: psd within 1e-4 of the max")
    db, dbw = g0.psd_db.cpu(), want.psd_db
    check(torch.equal(db == DB_FLOOR, dbw == DB_FLOOR), "first window: floors")
    db_err = {lvl: float((db - dbw).abs()[dbw > lvl].max()) for lvl in (-100, -120)}
    check(db_err[-100] <= 1e-3 and db_err[-120] <= 2e-3,
          "first window: psd_db within 1e-3 dB above -100 dB, 2e-3 above -120")
    for name in ("norm_power", "carry"):
        check(torch.allclose(getattr(g0, name).cpu(), getattr(want, name),
                             rtol=1e-5, atol=0), f"first window: {name} rtol 1e-5")
    print(f"[stream] first window on cuda = the CPU plain path: waterfall "
          f"{w_snr:.2f} dB SNR (tol 100 dB), psd max err "
          f"{psd_err:.3g} of the max (tol 1e-4), psd_db {db_err[-100]:.3g} dB "
          f"above -100 dB (tol 1e-3), {db_err[-120]:.3g} above -120 (tol 2e-3)")

    # Window-split invariance on the card: 4 × 256 against 1 × 1,024 frames.
    full = StreamingProcessor(cfg, 1, frames, dev).process_window(raw[:1], cal[:1])
    n = [int(r.col_count[0]) for r in got]
    n_full = int(full.col_count[0])
    check(sum(n) == n_full, f"split columns {n} sum to {n_full}")
    split = torch.cat([r.psd[0, :, :k] for r, k in zip(got, n)], dim=1)
    whole = full.psd[0, :, :n_full]
    split_err = float(((split - whole).abs() / whole.max()).max())
    check(split_err <= 1e-5, "split columns equal the one-window columns "
          "(within 1e-5 of the max)")
    print(f"[stream] window split 4×{window} vs 1×{frames} on channel 0: "
          f"{n_full} columns, max err {split_err:.3g} of the max (tol 1e-5)")

    # Host synchronizations per window, inputs on the host and on the card.
    raw_d = torch.as_tensor(raw[:, :window], device=dev)
    cal_d = torch.as_tensor(cal, device=dev)
    syncs_dev = count_syncs(lambda: sp.process_window(raw_d, cal_d))
    syncs_host = count_syncs(lambda: sp.process_window(raw[:, :window], cal))
    print(f"[stream] host syncs per window: {syncs_dev} with inputs on the "
          f"card, {syncs_host} with host NumPy inputs")

    out = {"launches_per_window": launches["fast_time_profile_b3"] // windows,
           "syncs_device_inputs": syncs_dev, "syncs_host_inputs": syncs_host}
    for mode in ("per_window", "running_max"):
        proc = StreamingProcessor(cfg, channels, window, dev, db_mode=mode)
        for src in ("host", "device"):
            inputs = [((raw[:, i * window:(i + 1) * window], cal) if src == "host"
                       else (torch.as_tensor(raw[:, i * window:(i + 1) * window],
                                             device=dev), cal_d))
                      for i in range(windows)]
            ms = []
            for k in range(timed + 3):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                proc.process_window(*inputs[k % windows])
                stop.record()
                stop.synchronize()
                if k >= 3:  # the first windows warm the caches
                    ms.append(start.elapsed_time(stop))
            med = statistics.median(ms)
            fps = channels * window / (med / 1e3)
            out[f"{mode}_{src}_ms"] = med
            print(f"[stream] {mode}, inputs on the {src}: window latency median "
                  f"{med:.4f} ms (min {min(ms):.4f}, max {max(ms):.4f}, "
                  f"{len(ms)} windows) = {fps:,.0f} frames/s "
                  f"({channels} ch × {window} frames)")
    return out


def classify_phase(dev, tmp: str, shape=VGG_SHAPE, batches=VGG_BATCHES) -> dict:
    """[classify] VGG16 (the repo's: 13 convolutions of 64-512 channels,
    the 256-wide binary head) at 224×224×3 with Flax's default
    initialization from a seeded generator on the card: the artifact round
    trip, bf16 against float32 (TF32 off), a lone image against the same
    image in a padded bucket, and the forward's time at batch 1, 8, 64."""
    from fmcw_radar_processing_tpu_torch.models.infer import (
        SpectrogramClassifier,
        export_classifier,
    )
    from fmcw_radar_processing_tpu_torch.models.params import state_dict_to_flax
    from fmcw_radar_processing_tpu_torch.models.vgg import (
        build_model,
        init_flax_default_,
    )

    print(f"[classify] card: {card_line()}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    f32 = init_flax_default_(build_model("vgg16", shape, dtype=torch.float32,
                                         device=dev), gen)
    n_params = sum(p.numel() for p in f32.parameters())
    t0 = time.perf_counter()
    art = export_classifier(os.path.join(tmp, "vgg16"), "vgg16",
                            state_dict_to_flax(f32.state_dict()), shape,
                            ("calf", "human"))
    clf = SpectrogramClassifier.load(art, dev)
    size = os.path.getsize(os.path.join(art, "params.npz"))
    print(f"[classify] VGG16 {n_params:,} parameters ({size / 1e6:.1f} MB "
          f"params.npz) exported and loaded in {time.perf_counter() - t0:.2f} s")
    ref_state = f32.state_dict()
    for k, v in clf.model.state_dict().items():
        check(torch.equal(v, ref_state[k]), f"artifact round trip: {k}")

    x = np.random.default_rng(SEED + 4).uniform(
        0, 1, (max(batches), *shape)).astype(np.float32)
    xd = torch.as_tensor(x, device=dev)
    with torch.inference_mode():
        l32 = f32(xd[:8]).float()
        l16 = clf.model(xd[:8]).float()
        # The last Dense's terms |w_i·h_i|: logits of random weights are
        # small sums of larger terms, so the bound scales with the terms.
        feats = f32.backbone(xd[:8].permute(0, 3, 1, 2))
        h = torch.relu(f32.head.fc(feats.permute(0, 2, 3, 1).flatten(1)))
        terms = float((h * f32.head.out.weight[0]).abs().sum(1).max())
    err = float((l16 - l32).abs().max())
    bound = 5e-2 * terms
    same = int(((l16 > 0) == (l32 > 0)).sum())
    print(f"[classify] batch 8 logits, bf16 vs float32 (TF32 off): max |Δlogit| "
          f"{err:.4g} (bound 5e-2·max Σ|w·h| of the last Dense = {bound:.4g}; "
          f"max|logit| {float(l32.abs().max()):.4g}); same sign on {same}/8")
    check(err <= bound, "bf16 logits within 5e-2·Σ|w·h| of float32")
    del f32, ref_state, feats, h
    torch.cuda.empty_cache()

    p1 = clf.predict_proba(x[:1])
    p5 = clf.predict_proba(x[:5])  # bucket 8, three padded rows
    d = float(abs(p1[0] - p5[0]))
    print(f"[classify] a lone image vs the same image in a padded bucket of 8: "
          f"|Δp| {d:.3g} (tol 2e-3)")
    check(d <= 2e-3, "batch 1 = the same image inside a padded bucket")

    def forward(b):
        def run():
            with torch.inference_mode():
                clf.model(xd[:b])
        return run

    times = time_turns({b: forward(b) for b in batches})
    for b, ms in times.items():
        print(f"[classify] VGG16 bf16 forward at batch {b}: {ms:.4f} ms "
              f"({b / (ms / 1e3):,.0f} images/s; CUDA events, median of {REPS})")
    return {"artifact": art, "params": n_params, "forward_ms": times,
            "bf16_err": err}


def service_phase(dev, tmp: str, small, artifact: str, reps: int = 3) -> dict:
    """[service] RadarHttpService on 127.0.0.1 with the VGG16 artifact:
    /process "no" (fidelity) and "yes", the dashboard's manifest over the
    payloads, /classify alone and eight at once, and /classify latency at
    1, 8 and 64 images in one request."""
    import base64
    import concurrent.futures
    import threading
    import urllib.request

    from fmcw_radar_processing_tpu_torch import LocalStorage, write_recording
    from fmcw_radar_processing_tpu_torch.serve.dashboard import DashboardServer
    from fmcw_radar_processing_tpu_torch.serve.handler import HandlerConfig
    from fmcw_radar_processing_tpu_torch.serve.http_service import RadarHttpService

    def post(url, body: bytes, ctype="application/json"):
        req = urllib.request.Request(url, data=body, method="POST",
                                     headers={"Content-Type": ctype})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read()), time.perf_counter() - t

    def get(url):
        with urllib.request.urlopen(url, timeout=60) as r:
            return json.loads(r.read())

    print(f"[service] card: {card_line()}")
    blobs, work = os.path.join(tmp, "svc_blobs"), os.path.join(tmp, "svc_work")
    os.makedirs(work)
    store = LocalStorage(blobs)
    xml, bin_ = write_recording(os.path.join(tmp, "svc_radar_data"), small)
    store.put(xml, "radar_data.xml")
    store.put(bin_, "radar_data.raw.bin")
    hc = HandlerConfig(workdir=work, storage_spec=f"local:{blobs}",
                       pretty_json=False, device=str(dev))
    check(hc.profile == "fidelity", "the service's default profile is fidelity")
    out: dict = {}
    t0 = time.perf_counter()
    with RadarHttpService(hc, port=0, classifier_artifact=artifact) as srv:
        out["start_s"] = time.perf_counter() - t0
        print(f"[service] up at {srv.url} in {out['start_s']:.2f} s (classifier "
              "loaded and warmed at buckets 1-64)")
        for flag in ("no", "yes"):
            st, res, dt = post(srv.url + "process", json.dumps(
                {"processAnimalActivity": flag}).encode())
            check(st == 200 and res["status"] == "success", f"/process {flag}: {res}")
            out[f"process_{flag}_s"] = dt
            print(f"[service] POST /process {flag!r}: {st} {res['status']} in "
                  f"{dt:.4f} s; artifacts {res['steps'][1]['artifacts']}")
        with DashboardServer(work, port=0) as dash:
            man = get(dash.url + "api/manifest")
            with urllib.request.urlopen(dash.url + "data/spectrogram.png",
                                        timeout=60) as r:
                png = r.read()
        check(None not in (man["spectrogram"], man["range_fft"], man["range_speed"],
                           man["fft_snapshot"], man["png"])
              and len(man["batches"]) == 3 and png.startswith(b"\x89PNG"),
              f"dashboard manifest: {man}")
        print(f"[service] dashboard manifest: {man}")

        st, res, dt = post(srv.url + "classify", png, "image/png")
        check(st == 200 and len(res["predictions"]) == 1, f"/classify: {res}")
        print(f"[service] POST /classify spectrogram.png: {st} "
              f"{res['predictions'][0]} in {dt:.4f} s")

        # Eight at once, released together; repeated (at most 3 rounds)
        # until the dispatcher has coalesced requests into one batch.
        for rnd in range(3):
            gate = threading.Barrier(8)

            def one(_):
                gate.wait(timeout=60)
                return post(srv.url + "classify", png, "image/png")

            with concurrent.futures.ThreadPoolExecutor(8) as ex:
                res8 = [f.result(timeout=300) for f in
                        [ex.submit(one, i) for i in range(8)]]
            check(all(r[0] == 200 for r in res8), "8 concurrent /classify: 200")
            batching = get(srv.url + "healthz")["classify_batching"]
            if batching["max_batch"] > 1:
                break
        lat = sorted(r[2] for r in res8)
        print(f"[service] 8 concurrent /classify (round {rnd + 1}): all 200, "
              f"latency {lat[0]:.4f}-{lat[-1]:.4f} s; batching {batching}")
        check(batching["max_batch"] > 1, "concurrent /classify coalesced")
        out["classify_8_concurrent_s"] = lat

        b64 = base64.b64encode(png).decode()
        for n in (1, 8, 64):
            body = json.dumps({"images_b64": [b64] * n}).encode()
            ts = []
            for _ in range(reps):
                st, res, dt = post(srv.url + "classify", body)
                check(st == 200 and len(res["predictions"]) == n, f"/classify {n}")
                ts.append(dt)
            out[f"classify_{n}_s"] = statistics.median(ts)
            print(f"[service] POST /classify with {n} image(s): median "
                  f"{out[f'classify_{n}_s']:.4f} s of {reps} (min {min(ts):.4f})")
        print(f"[service] healthz {get(srv.url + 'healthz')}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a CUDA "
              "card", file=sys.stderr)
        return 2

    from fmcw_radar_processing_tpu_torch import (
        AlgorithmConfig,
        LocalStorage,
        RadarConfig,
        SyntheticTarget,
        default_device_config,
        synthesize_recording,
        write_recording,
    )
    from fmcw_radar_processing_tpu_torch.dsp.stft import DB_FLOOR, StftOperator
    from fmcw_radar_processing_tpu_torch.ops import _lib
    from fmcw_radar_processing_tpu_torch.ops import detect_cuda as dtc
    from fmcw_radar_processing_tpu_torch.ops import fast_time_cuda as ftc
    from fmcw_radar_processing_tpu_torch.ops import stft_cuda as stc
    from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import (
        make_frame_chain,
        pack_slow_time,
    )
    from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline
    from fmcw_radar_processing_tpu_torch.serve.handler import (
        HandlerConfig,
        RadarService,
    )
    from fmcw_radar_processing_tpu_torch.utils.cplx import (
        pair_abs,
        pin_f32_matmul,
        to_pair,
    )
    from fmcw_radar_processing_tpu_torch.utils.observe import StageTimer

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. The card, the versions, the precision flags.
    print(card_line())
    pin_f32_matmul()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 off")

    # 2. Build the kernels from csrc/.
    t0 = time.perf_counter()
    _lib.load_kernels()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({_lib.library_path().name})")
    log = _lib.library_path().with_suffix(".log")
    if log.exists():  # ptxas -v: registers and spills of every kernel
        text = log.read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", text)]
        # K1a and K1c are profile_wgmma_kernel<3> and <1> (mangled ILi3EE,
        # ILi1EE): "Function properties for" the name, a stack line, "Used".
        wg = dict(re.findall(r"Function properties for \S*profile_wgmma_kernelILi(\d)EE"
                             r"\S*\n[^\n]*\n[^\n]*Used (\d+) registers", text))
        print(f"[build] ptxas: {len(regs)} kernels, at most {max(regs)} registers "
              f"a thread (K1a {wg.get('3', '?')}, K1c {wg.get('1', '?')}), "
              f"{sum(spills)} bytes of spill stores in all")

    # The main path's input: a 65,536-frame recording, two targets, about
    # 10% of frames muted so that slow-time packing is not the identity.
    cfg = RadarConfig.create(default_device_config(), AlgorithmConfig.production())
    rng = np.random.default_rng(SEED)
    present = rng.random(FRAMES) >= MUTED_SHARE
    strong = SyntheticTarget(range_m=7.5, doppler_bin_offset=3, amplitude=4.0)
    weak = SyntheticTarget(range_m=16.9, doppler_bin_offset=-2, amplitude=2.0)
    t0 = time.perf_counter()
    rec = synthesize_recording(cfg, FRAMES, (strong, weak), seed=SEED,
                               target_present=present)
    raw = to_pair(rec.rx1()).reshape(FRAMES, cfg.pn, 2 * cfg.nts)
    calib = to_pair(rec.calib_vector(0, cfg.nts))
    print(f"[setup] synthesized {FRAMES} frames in "
          f"{time.perf_counter() - t0:.1f} s; {int(present.sum())} with targets")

    # 3. Kernel parity at the main-path shapes, and 4. timing.
    rows: list[dict] = []

    # K1a and K1b on x [F·PN, 128].
    w = ftc.blocked_weight(cfg, dev)
    w_hi, w_lo = ftc.split_bf16x3(w)
    off = ftc.calib_offset(torch.as_tensor(calib, device=dev), w)
    x = torch.as_tensor(raw, device=dev).reshape(-1, 2 * cfg.nts)
    rows_x, k_bins = x.shape[0], cfg.range_fft_size
    prof_bytes = rows_x // cfg.pn * k_bins * 4
    product_ops = 2.0 * rows_x * x.shape[1] * 2 * k_bins  # one [rows,128]@[128,512]

    # K1a: held to its plain version (the same split) and to the exact
    # plain profile (100 dB, the bf16x3 class).
    prof_a = ftc.fast_time_profile_b3(x, w_hi, w_lo, off, cfg.pn)
    prof_a_ref = ftc.fast_time_profile_b3_ref(x, w_hi, w_lo, off, cfg.pn)
    prof = ftc.fast_time_profile_ref(x, w, off, cfg.pn)
    err = (prof_a - prof_a_ref).abs()
    k1a_err = float(err.max())
    k1a_snr = snr_db(prof_a, prof)
    k1a_ok = bool((err <= 1e-2 + 1e-5 * prof_a_ref.abs()).all()) and k1a_snr >= 100.0
    print(f"[parity] K1a fast_time_profile_b3 {tuple(x.shape)} -> "
          f"{tuple(prof_a.shape)}: max_abs_err {k1a_err:.6g} vs its plain "
          f"version (tol 1e-2 + 1e-5·|ref|); {k1a_snr:.2f} dB SNR vs the exact "
          f"plain profile (tol 100 dB) {'ok' if k1a_ok else 'FAIL'}")
    check(k1a_ok, "K1a parity")
    del prof_a, prof_a_ref, err
    ms1a, plain_ms1a, second1a = time_pair(
        lambda: ftc.fast_time_profile_b3(x, w_hi, w_lo, off, cfg.pn),
        lambda: ftc.fast_time_profile_b3_ref(x, w_hi, w_lo, off, cfg.pn))
    xb = x.to(torch.bfloat16)
    yard_ms = time_turns({"mm": lambda: torch.matmul(xb, w_hi)})["mm"]
    del xb
    print(f"[time] K1a kernel {ms1a:.4f} ms (second in its turn {second1a:.4f}), "
          f"plain {plain_ms1a:.4f} ms (median of {REPS}); yardstick, not used "
          f"by the port: one bf16 "
          f"torch.matmul [{rows_x},128]@[128,512] alone {yard_ms:.4f} ms")
    rows.append(dict(name="fast_time_profile_b3", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/fast_time_profile_b3.cu",
                     replaces="fmcw_radar_processing_tpu/ops/fast_time_pallas.py:151",
                     max_abs_err=k1a_err, ms=ms1a, plain_ms=plain_ms1a, ms_second=second1a,
                     bound=bound(x.numel() * 4 + 2 * w_hi.numel() * 2
                                 + off.numel() * 4 + prof_bytes,
                                 3 * product_ops, "bf16")))

    # K1c (impl "pallas_profile_bf16"): one bf16 pass, held to its plain
    # version (the same rounding) and to the exact plain profile (45 dB).
    prof_c = ftc.fast_time_profile_bf16(x, w_hi, off, cfg.pn)
    prof_c_ref = ftc.fast_time_profile_bf16_ref(x, w_hi, off, cfg.pn)
    err = (prof_c - prof_c_ref).abs()
    k1c_err = float(err.max())
    k1c_snr = snr_db(prof_c, prof)
    k1c_ok = bool((err <= 1e-2 + 1e-5 * prof_c_ref.abs()).all()) and k1c_snr >= 45.0
    print(f"[parity] K1c fast_time_profile_bf16 {tuple(x.shape)} -> "
          f"{tuple(prof_c.shape)}: max_abs_err {k1c_err:.6g} vs its plain "
          f"version (tol 1e-2 + 1e-5·|ref|); {k1c_snr:.2f} dB SNR vs the exact "
          f"plain profile (tol 45 dB) {'ok' if k1c_ok else 'FAIL'}")
    check(k1c_ok, "K1c parity")
    del prof_c, prof_c_ref, err
    ms1c, plain_ms1c, second1c = time_pair(
        lambda: ftc.fast_time_profile_bf16(x, w_hi, off, cfg.pn),
        lambda: ftc.fast_time_profile_bf16_ref(x, w_hi, off, cfg.pn))
    print(f"[time] K1c kernel {ms1c:.4f} ms (second in its turn {second1c:.4f}), "
          f"plain {plain_ms1c:.4f} ms (median of {REPS}); the same yardstick, "
          f"not used by the port: one bf16 torch.matmul [{rows_x},128]@[128,512] "
          f"alone {yard_ms:.4f} ms")
    rows.append(dict(name="fast_time_profile_bf16", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/fast_time_profile_b3.cu",
                     replaces="fmcw_radar_processing_tpu/ops/fast_time_pallas.py:130",
                     max_abs_err=k1c_err, ms=ms1c, plain_ms=plain_ms1c,
                     ms_second=second1c,
                     bound=bound(x.numel() * 4 + w_hi.numel() * 2
                                 + off.numel() * 4 + prof_bytes,
                                 product_ops, "bf16")))

    # K1b, the exact class (impl "pallas_profile").
    prof_b = ftc.fast_time_profile(x, w, off, cfg.pn)
    err = (prof_b - prof).abs()
    k1_err = float(err.max())
    k1_ok = bool((err <= 1e-2 + 1e-5 * prof.abs()).all())
    print(f"[parity] K1b fast_time_profile {tuple(x.shape)} -> {tuple(prof_b.shape)}: "
          f"max_abs_err {k1_err:.6g} (tol 1e-2 + 1e-5·|ref|) "
          f"{'ok' if k1_ok else 'FAIL'}")
    check(k1_ok, "K1b parity")
    prof = prof_b
    ms, plain_ms, second1b = time_pair(lambda: ftc.fast_time_profile(x, w, off, cfg.pn),
                             lambda: ftc.fast_time_profile_ref(x, w, off, cfg.pn))
    print(f"[time] K1b kernel {ms:.4f} ms (second in its turn {second1b:.4f}), "
          f"plain {plain_ms:.4f} ms (median of {REPS})")
    rows.append(dict(name="fast_time_profile", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/fast_time_profile.cu",
                     replaces="fmcw_radar_processing_tpu/ops/fast_time_pallas.py:130",
                     max_abs_err=k1_err, ms=ms, plain_ms=plain_ms, ms_second=second1b,
                     bound=bound(x.numel() * 4 + w.numel() * 4 + off.numel() * 4
                                 + prof_bytes, product_ops, "f32")))
    del err, prof_b

    # K6 on the same x: the range FFT [F, PN, K, 2] (2 GiB) and the profile.
    rf, prof6 = ftc.fast_time(x, w, off, cfg.pn)
    rf_ref, prof6_ref = ftc.fast_time_ref(x, w, off, cfg.pn)
    err = (rf - rf_ref).abs()
    k6_err = float(err.max())
    k6_ok = bool((err <= 1e-2 + 1e-5 * rf_ref.abs()).all())
    del err, rf_ref
    perr = (prof6 - prof).abs()
    k6_ok &= bool((perr <= 1e-2 + 1e-5 * prof.abs()).all())
    k6_ok &= bool(((prof6 - prof6_ref).abs() <= 1e-2 + 1e-5 * prof6_ref.abs()).all())
    print(f"[parity] K6 fast_time {tuple(x.shape)} -> rf {tuple(rf.shape)}: "
          f"rf max_abs_err {k6_err:.6g} vs plain, profile max_abs_err "
          f"{float(perr.max()):.6g} vs K1 (bit-equal: {bool(torch.equal(prof6, prof))}) "
          f"(tol 1e-2 + 1e-5·|ref|) {'ok' if k6_ok else 'FAIL'}")
    check(k6_ok, "K6 parity")
    del rf, perr, prof6_ref, prof
    torch.cuda.empty_cache()
    ms6, plain_ms6, second6 = time_pair(lambda: ftc.fast_time(x, w, off, cfg.pn),
                               lambda: ftc.fast_time_ref(x, w, off, cfg.pn))
    print(f"[time] K6 kernel {ms6:.4f} ms, plain {plain_ms6:.4f} ms "
          f"(median of {REPS})")
    rows.append(dict(name="fast_time", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/fast_time_profile.cu",
                     replaces="fmcw_radar_processing_tpu/ops/fast_time_pallas.py:35",
                     max_abs_err=k6_err, ms=ms6, plain_ms=plain_ms6, ms_second=second6,
                     bound=bound(x.numel() * 4 + w.numel() * 4 + off.numel() * 4
                                 + prof_bytes + rows_x * k_bins * 2 * 4,
                                 product_ops, "f32")))
    torch.cuda.empty_cache()

    # K7 on K6's profile [65,536, 256], at T = 1 and on a T = 3 config: every
    # slot equal to the plain version, invalid ones included.
    cfg3 = RadarConfig.create(default_device_config(),
                              AlgorithmConfig.production(max_num_targets=3))
    k7_err = 0.0
    for c in (cfg, cfg3):
        got = dtc.search_peaks_fused(prof6, c)
        want = dtc.search_peaks_fused_ref(prof6, c)
        same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
        k7_err = max(k7_err, float((got.magnitude - want.magnitude).abs().max()))
        n_valid = int(got.valid.sum())
        print(f"[parity] K7 search_peaks_fused {tuple(prof6.shape)} T="
              f"{c.algorithm.max_num_targets}: idx, magnitude, valid equal "
              f"{same}; {n_valid} valid of {got.valid.numel()} slots "
              f"{'ok' if all(same) else 'FAIL'}")
        check(all(same) and 0 < n_valid < got.valid.numel(), "K7 parity")
    ms7, plain_ms7, second7 = time_pair(lambda: dtc.search_peaks_fused(prof6, cfg),
                               lambda: dtc.search_peaks_fused_ref(prof6, cfg))
    print(f"[time] K7 kernel {ms7:.4f} ms, plain {plain_ms7:.4f} ms "
          f"(T=1, median of {REPS})")
    rows.append(dict(name="search_peaks_fused", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/detect.cu",
                     replaces="fmcw_radar_processing_tpu/ops/detect_pallas.py:29",
                     max_abs_err=k7_err, ms=ms7, plain_ms=plain_ms7, ms_second=second7,
                     bound=bound(prof6.numel() * 4 + prof6.shape[0] * (4 + 4 + 1),
                                 3.0 * prof6.numel(), "f32")))
    del prof6, got, want
    torch.cuda.empty_cache()

    # K2 + K3 on a packed-signal-shaped input: L = F·PN, about 90% valid.
    op = StftOperator.create(window_length=20, beta=3.0, nfft=256,
                             fs=1.0 / cfg.derived.prt)
    length = FRAMES * cfg.pn
    count = int(present.sum()) * cfg.pn
    sig_np = np.zeros(length, np.float32)
    sig_np[:count] = np.abs(rng.standard_normal(count)
                            + 4.0 * np.sin(np.arange(count) * 0.3)).astype(np.float32)
    sig = torch.as_tensor(sig_np, device=dev)
    nb = op.num_bins
    t_pad = -(-(length - 19) // stc.PSD_TILE) * stc.PSD_TILE
    k2_err = 0.0
    k3_err = 0.0
    for db_dtype, int_dtype in ((torch.float32, torch.float32),
                                (torch.bfloat16, torch.bfloat16)):
        align = 16 if db_dtype == torch.bfloat16 else 8
        nb_pad = -(-nb // align) * align
        a2 = torch.as_tensor(stc._folded_operator(op, align), device=dev)
        p, tmax = stc.psd_phase1(sig, count - 19, a2, nb_pad, t_pad)
        p_ref, tmax_ref = stc.psd_phase1_ref(sig, count - 19, a2, nb_pad, t_pad)
        perr = (p - p_ref).abs()
        k2_ok = bool((perr <= 1e-10 + 1e-4 * p_ref.abs()).all()) and bool(
            ((tmax - tmax_ref).abs() <= 1e-5 * tmax_ref.abs()).all())
        k2_err = max(k2_err, float(perr.max()))
        print(f"[parity] K2 psd_phase1 L={length} nb_pad={nb_pad}: p max_abs_err "
              f"{float(perr.max()):.6g} (tol 1e-10 + 1e-4·|ref|; gmax "
              f"{float(tmax_ref.max()):.6g}) {'ok' if k2_ok else 'FAIL'}")
        check(k2_ok, "K2 parity")
        del perr, p_ref
        gmax = tmax.amax()
        db, out = stc.db_rescale(p, gmax, nb, 1024, db_dtype, int_dtype)
        db_ref, out_ref = stc.db_rescale_ref(p, gmax, nb, 1024, db_dtype, int_dtype)
        floor_ok = bool(torch.equal(db == DB_FLOOR, db_ref == DB_FLOOR))
        errs = []
        ok = floor_ok
        for got, want in ((db, db_ref), (out, out_ref)):
            d = (got.float() - want.float()).abs()
            errs.append(float(d.max()))
            if db_dtype == torch.float32:
                ok &= bool((d <= 2e-3).all())
            else:
                ok &= bool((d <= bf16_ulp(want.float())).all())
            del d
        tol = "2e-3 dB" if db_dtype == torch.float32 else "one bf16 ulp"
        print(f"[parity] K3 db_rescale stores {str(db_dtype)[6:]}: db max_abs_err "
              f"{errs[0]:.6g}, intensity max_abs_err {errs[1]:.6g} (tol {tol}); "
              f"floor mask equal {floor_ok} {'ok' if ok else 'FAIL'}")
        check(ok, f"K3 parity ({db_dtype})")
        if db_dtype == torch.float32:
            k3_err = max(errs)
        del db, out, db_ref, out_ref
    # Time the production variant (bf16 stores, nb_pad 144).
    ms2, plain_ms2, second2 = time_pair(
        lambda: stc.psd_phase1(sig, count - 19, a2, nb_pad, t_pad),
        lambda: stc.psd_phase1_ref(sig, count - 19, a2, nb_pad, t_pad))
    ms3, plain_ms3, second3 = time_pair(
        lambda: stc.db_rescale(p, gmax, nb, 1024, torch.bfloat16, torch.bfloat16),
        lambda: stc.db_rescale_ref(p, gmax, nb, 1024, torch.bfloat16,
                                   torch.bfloat16))
    print(f"[time] K2 kernel {ms2:.4f} ms, plain {plain_ms2:.4f} ms; "
          f"K3 kernel {ms3:.4f} ms (second in its turn {second3:.4f}), plain "
          f"{plain_ms3:.4f} ms (median of {REPS})")
    rows.append(dict(name="psd_phase1", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/stft_export.cu",
                     replaces="fmcw_radar_processing_tpu/ops/stft_pallas.py:134",
                     max_abs_err=k2_err, ms=ms2, plain_ms=plain_ms2, ms_second=second2,
                     bound=bound(length * 4 + a2.numel() * 4 + nb_pad * t_pad * 4
                                 + t_pad // stc.PSD_TILE * 4,
                                 psd_ops(count - 19, nb_pad), "f32")))
    rows.append(dict(name="db_rescale", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/stft_export.cu",
                     replaces="fmcw_radar_processing_tpu/ops/stft_pallas.py:282",
                     max_abs_err=k3_err, ms=ms3, plain_ms=plain_ms3, ms_second=second3,
                     bound=bound(nb_pad * t_pad * (4 + 2) + 1024 * t_pad * 2
                                 + 1024 * 12 + 4, db_ops(t_pad, nb_pad), "f32")))
    del p, tmax
    torch.cuda.empty_cache()
    # K3 at nfft 512 (the production profile's stft_nfft=512 option) on the
    # last 16,384 frames' samples, which straddle the valid count.
    start = length - 16_384 * cfg.pn
    check(0 < count - start < length - start, "the nfft 512 input straddles the count")
    k3_wide_check(stc, DB_FLOOR, sig[start:].contiguous(), count - start - 19,
                  StftOperator.create(window_length=20, beta=3.0, nfft=512,
                                      fs=1.0 / cfg.derived.prt))
    del sig, x
    torch.cuda.empty_cache()

    # K4a + K4b at the fidelity main path's shape: L = 1,024 frames · 16,
    # about 90% valid, nfft 16,384 (nb 8,193, a partial last bin block).
    f_len = FIDELITY_FRAMES * cfg.pn
    f_count = int(present[:FIDELITY_FRAMES].sum()) * cfg.pn
    f_op = StftOperator.create(window_length=20, beta=3.0, nfft=16_384,
                               fs=1.0 / cfg.derived.prt)
    f_nb_pad = -(-f_op.num_bins // 8) * 8
    f_t_pad = -(-(f_len - 19) // stc.PSD_TILE) * stc.PSD_TILE
    sig = torch.as_tensor(sig_np[:f_len].copy(), device=dev)
    sig[f_count:] = 0.0
    k4_errs = []
    for int_dtype in (torch.float32, torch.int8, torch.bfloat16):
        errs, ops_ = k4_check(stc, DB_FLOOR, sig, f_count, f_op, int_dtype)
        if int_dtype == torch.float32:
            k4_errs.append(errs)
            (ms4a, plain_ms4a, second4a), (ms4b, plain_ms4b, second4b) = k4_times(
                stc, f_op.num_bins, ops_, REPS)
            # The share of a first-in-turn reading that is the allocator's:
            # torch.empty of a dB map alone, in turns with K4b's plain version.
            p_f, g_f = ops_[5], ops_[6]
            al_first, _, al_second = time_pair(
                lambda: torch.empty_like(p_f),
                lambda: stc.db_rescale_ref(p_f, g_f, f_op.num_bins, 1024,
                                           torch.float32, torch.float32))
            del p_f, g_f
        del ops_
    print(f"[time] K4a kernel {ms4a:.4f} ms, plain {plain_ms4a:.4f} ms; "
          f"K4b kernel {ms4b:.4f} ms, plain {plain_ms4b:.4f} ms "
          f"(nfft {f_op.nfft}, L {f_len}, float32 stores, median of {REPS}); "
          f"K4a second in its turn {second4a:.4f} ms, K4b {second4b:.4f} ms; "
          f"torch.empty of the [{f_nb_pad}, {f_t_pad}] float32 dB map alone, "
          f"in turns with K4b's plain version: {al_first:.4f} ms first, "
          f"{al_second:.4f} ms second")
    del sig
    torch.cuda.empty_cache()

    # Index width: L = 65,536 at nfft 65,536, where nb_pad · t_pad =
    # 32,776 · 65,536 > 2^31. The last 2,048 columns straddle the valid count.
    w_op = StftOperator.create(window_length=20, beta=3.0, nfft=65_536,
                               fs=1.0 / cfg.derived.prt)
    w_len = 4_096 * cfg.pn
    sig = torch.as_tensor(sig_np[:w_len].copy(), device=dev)
    sig[w_len - 1000:] = 0.0
    errs, ops_ = k4_check(stc, DB_FLOOR, sig, w_len - 1000, w_op, torch.float32,
                          last_cols=2048)
    k4_errs.append(errs)
    torch.cuda.empty_cache()
    (wms4a, wplain4a, _), (wms4b, wplain4b, _) = k4_times(stc, w_op.num_bins, ops_,
                                                    WIDE_REPS)
    print(f"[time] K4a kernel {wms4a:.4f} ms, plain {wplain4a:.4f} ms; "
          f"K4b kernel {wms4b:.4f} ms, plain {wplain4b:.4f} ms "
          f"(nfft {w_op.nfft}, L {w_len}, float32 stores, median of {WIDE_REPS})")
    rows.append(dict(name="psd_phase1_tiled", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/stft_export_tiled.cu",
                     replaces="fmcw_radar_processing_tpu/ops/stft_pallas.py:215",
                     max_abs_err=max(e[0] for e in k4_errs), ms=ms4a,
                     plain_ms=plain_ms4a, ms_second=second4a,
                     bound=bound(f_len * 4 + 2 * f_nb_pad * 20 * 4
                                 + f_nb_pad * f_t_pad * 4
                                 + -(-f_nb_pad // 128) * f_t_pad // stc.PSD_TILE * 4,
                                 psd_ops(f_count - 19, f_nb_pad), "f32")))
    rows.append(dict(name="db_rescale_tiled", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/stft_export_tiled.cu",
                     replaces="fmcw_radar_processing_tpu/ops/stft_pallas.py:238",
                     max_abs_err=max(max(e[1:]) for e in k4_errs), ms=ms4b,
                     plain_ms=plain_ms4b, ms_second=second4b,
                     bound=bound(f_nb_pad * f_t_pad * (4 + 4) + 1024 * f_t_pad * 4
                                 + 1024 * 12 + 4, db_ops(f_t_pad, f_nb_pad), "f32")))
    del sig, ops_
    torch.cuda.empty_cache()

    # 5a. A small recording on the card against the port's CPU path (the
    # plain versions, held to the JAX package and the f64 oracle by the
    # tests). This also warms cuBLAS and the allocator.
    small = synthesize_recording(cfg, 256, (strong, weak), seed=SEED + 1,
                                 target_present=present[:256])
    s_raw, s_cal = to_pair(small.rx1()), to_pair(small.calib_vector(0, cfg.nts))
    pipe = RadarPipeline(cfg, device=dev)
    got = pipe.process_recording(s_raw, s_cal)
    # The same impl on the CPU: "auto" is K1a's bf16x3 on the card but the
    # exact profile there.
    want = RadarPipeline(cfg, device="cpu", impl="pallas_profile_high"
                         ).process_recording(s_raw, s_cal)
    check(np.array_equal(got.detected, want.detected), "small: detected")
    check(np.array_equal(got.target_range, want.target_range, equal_nan=True),
          "small: ranges")
    check(np.array_equal(got.target_speed, want.target_speed, equal_nan=True),
          "small: speeds")
    check(np.allclose(got.waterfall, want.waterfall, rtol=1e-5, atol=1e-2),
          "small: waterfall")
    for name in ("spectrogram_intensity", "spectrogram_psd_db"):
        a = torch.as_tensor(getattr(got, name))
        b = torch.as_tensor(getattr(want, name))
        check(a.shape == b.shape, f"small: {name} shape")
        band = b > -120
        tol = torch.maximum(bf16_ulp(torch.maximum(a.abs(), b.abs())),
                            torch.tensor(1e-3))
        check(bool(((a - b).abs() <= tol)[band].all()),
              f"small: {name} within one bf16 ulp above -120 dB")
    print("[small] 256-frame recording on cuda matches the CPU plain path")

    # 5a''. The same recording at stft_hop=4: the JAX package's XLA branch
    # (operator product, float32 dB map, rescale, bf16 cast) in plain
    # PyTorch on the card, against the CPU plain path; no export kernel.
    hcfg = RadarConfig.create(default_device_config(),
                              AlgorithmConfig.production(stft_hop=4))
    hpipe = RadarPipeline(hcfg, device=dev)
    _lib.reset_launches()
    got = hpipe.process_recording(s_raw, s_cal)
    torch.cuda.synchronize()
    h_launches = dict(_lib.LAUNCHES)
    want = RadarPipeline(hcfg, device="cpu", impl="pallas_profile_high"
                         ).process_recording(s_raw, s_cal)
    check(h_launches["fast_time_profile_b3"] > 0
          and not any(n for k, n in h_launches.items()
                      if k != "fast_time_profile_b3"),
          f"hop 4: the frame chain's K1a and no export kernel: {h_launches}")
    check(np.array_equal(got.detected, want.detected)
          and np.array_equal(got.target_range, want.target_range, equal_nan=True)
          and np.array_equal(got.target_speed, want.target_speed, equal_nan=True),
          "hop 4: detections, ranges, speeds")
    n_cols = (int(got.detected.sum()) * cfg.pn - 20) // 4 + 1
    check(got.spectrogram_intensity.shape == (1024, n_cols)
          and np.array_equal(got.spectrogram_times, want.spectrogram_times),
          f"hop 4: intensity (1024, {n_cols}) and its times")
    for name in ("spectrogram_intensity", "spectrogram_psd_db"):
        a = torch.as_tensor(getattr(got, name))
        b = torch.as_tensor(getattr(want, name))
        check(a.shape == b.shape, f"hop 4: {name} shape")
        tol = torch.maximum(bf16_ulp(torch.maximum(a.abs(), b.abs())),
                            torch.tensor(1e-3))
        check(bool(((a - b).abs() <= tol)[b > -120].all()),
              f"hop 4: {name} within one bf16 ulp above -120 dB")
    print(f"[hop 4] 256-frame production recording at stft_hop=4 on cuda "
          f"matches the CPU plain path: intensity (1024, {n_cols}), times "
          f"{got.spectrogram_times[:3].tolist()} s; launches {h_launches}")
    del hpipe

    # 5. The main path, counted and timed.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer = StageTimer()
    _lib.reset_launches()
    t0 = time.perf_counter()
    out = pipe.process_recording(raw, calib, timer=timer)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    print(f"[main] process_recording {FRAMES} frames: {seconds:.4f} s = "
          f"{FRAMES / seconds:,.0f} frames/s end to end (host decode included); "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(timer.pretty())
    print(f"[main] launches {launches}")
    for name in ("fast_time_profile_b3", "psd_phase1", "db_rescale"):
        check(launches[name] > 0, f"{name} launched on the main path")
    for name in ("fast_time_profile", "psd_phase1_tiled", "db_rescale_tiled"):
        check(launches[name] == 0, f"{name} not launched on the main path")
    check(np.array_equal(out.detected, present), "detected frames = target frames")
    det = out.detected
    want_range = np.float32(strong.range_bin(cfg)) * np.float32(cfg.derived.dist_per_bin)
    want_speed = np.float32(strong.doppler_bin_offset) * np.float32(
        -cfg.derived.fd_per_bin * cfg.derived.hz_to_mps)
    check(np.all(out.target_range[0, det] == want_range)
          and np.all(np.isnan(out.target_range[0, ~det])),
          f"ranges = {want_range}")
    check(np.all(out.target_speed[0, det] == want_speed), f"speeds = {want_speed}")
    print(f"[main] range {want_range} m and speed {want_speed} m/s in all "
          f"{int(det.sum())} detected frames "
          f"(injected {strong.range_bin(cfg) * cfg.derived.dist_per_bin} m, "
          f"{strong.reported_speed(cfg)} m/s)")
    n_valid = int(det.sum()) * cfg.pn - 19
    inten, psd = out.spectrogram_intensity, out.spectrogram_psd_db
    check(inten.shape == (1024, n_valid) and psd.shape == (129, n_valid),
          "spectrogram shapes")
    check(bool(np.isfinite(inten).all()), "intensity finite")
    check(float(psd.max()) == 0.0 and bool((psd >= DB_FLOOR).all()),
          "dB map normalized to 0 dB and floored at DB_FLOOR")
    floor_cols = (psd == DB_FLOOR).all(axis=0)
    check(not floor_cols.any(), "no valid column at the floor")
    print(f"[main] intensity {inten.shape} finite, dB map max 0, "
          f"{int((psd == DB_FLOOR).sum())} floor values, no floored column")
    main_waterfall = out.waterfall
    main_meas = (out.detected, out.target_range, out.target_speed)
    main_intensity = inten
    del out, psd

    # 5a'. The exact chain, impl "pallas_profile" (K1b), on the same
    # recording, counted: detections, ranges and speeds equal the main
    # path's (bf16x3) exactly, and the main path's waterfall is within
    # 100 dB of this exact one.
    xpipe = RadarPipeline(cfg, device=dev, impl="pallas_profile")
    xpipe.process_recording(s_raw, s_cal)  # warm
    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    xout = xpipe.process_recording(raw, calib)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    x_launches = dict(_lib.LAUNCHES)
    print(f"[exact] process_recording impl='pallas_profile' {FRAMES} frames: "
          f"{seconds:.4f} s; launches {x_launches}")
    check(x_launches["fast_time_profile"] > 0
          and x_launches["fast_time_profile_b3"] == 0,
          "impl='pallas_profile' runs K1b, not K1a")
    for name, a, b in zip(("detected", "ranges", "speeds"), main_meas,
                          (xout.detected, xout.target_range, xout.target_speed)):
        check(np.array_equal(a, b, equal_nan=a.dtype.kind == "f"),
              f"main path {name} = impl='pallas_profile' {name}")
    main_snr = snr_db(main_waterfall, xout.waterfall)
    check(main_snr >= 100.0, f"main path waterfall {main_snr:.2f} dB vs exact")
    print(f"[exact] detections, ranges and speeds of the main path (K1a) equal "
          f"the exact chain's (K1b); main-path waterfall {main_snr:.2f} dB SNR "
          "against it (tol 100 dB)")
    del xpipe, main_meas

    # 5a'''. impl "pallas_profile_bf16" (K1c) on the same recording, counted
    # and timed, held to the exact chain: ranges exact on the frames both
    # detect, at most 0.1% of frames detected differently.
    bpipe = RadarPipeline(cfg, device=dev, impl="pallas_profile_bf16")
    bpipe.process_recording(s_raw, s_cal)  # warm
    torch.cuda.synchronize()
    timer = StageTimer()
    _lib.reset_launches()
    t0 = time.perf_counter()
    bout = bpipe.process_recording(raw, calib, timer=timer)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    b_launches = dict(_lib.LAUNCHES)
    print(f"[bf16] process_recording impl='pallas_profile_bf16' {FRAMES} frames: "
          f"{seconds:.4f} s = {FRAMES / seconds:,.0f} frames/s end to end")
    print(timer.pretty())
    print(f"[bf16] launches {b_launches}")
    check(all(b_launches[k] == 1 for k in ("fast_time_profile_bf16", "psd_phase1",
                                           "db_rescale"))
          and all(b_launches[k] == 0 for k in ("fast_time_profile_b3",
                                               "fast_time_profile", "fast_time")),
          "impl='pallas_profile_bf16': K1c, K2, K3 once each; K1a, K1b, K6 never")
    held_to_exact("impl='pallas_profile_bf16'", bout, xout, 0.001)
    b_snr = snr_db(bout.waterfall, xout.waterfall)
    print(f"[bf16] waterfall {b_snr:.2f} dB SNR against the exact chain's")
    del bout, bpipe

    # 5b. The materializing chain, impl "pallas" (K6 + K7). First 256 frames
    # through make_frame_chain with the range FFT on the card against the
    # CPU plain path, then the 65,536-frame recording, counted and timed.
    s_dev = [torch.as_tensor(a, device=dev)
             for a in (s_raw.reshape(256, cfg.pn, -1), s_cal)]
    s_cpu = [torch.as_tensor(a) for a in (s_raw.reshape(256, cfg.pn, -1), s_cal)]
    got = make_frame_chain(cfg, dev, return_range_fft=True, impl="pallas")(*s_dev)
    want = make_frame_chain(cfg, "cpu", return_range_fft=True, impl="pallas")(*s_cpu)
    check(torch.equal(got.detection.idx.cpu(), want.detection.idx)
          and torch.equal(got.detected.cpu(), want.detected), "pallas small: detections")
    check(np.array_equal(got.range.cpu().numpy(), want.range.numpy(), equal_nan=True)
          and np.array_equal(got.speed.cpu().numpy(), want.speed.numpy(),
                             equal_nan=True), "pallas small: ranges and speeds")
    check(torch.allclose(got.waterfall.cpu(), want.waterfall, rtol=1e-5, atol=1e-2),
          "pallas small: waterfall")
    scale = float(want.range_fft.abs().max())
    for name in ("range_fft", "strongest_chirps"):
        check(torch.allclose(getattr(got, name).cpu(), getattr(want, name),
                             rtol=1e-5, atol=1e-5 * scale), f"pallas small: {name}")
    print("[pallas small] 256-frame impl='pallas' chain with the range FFT on "
          "cuda matches the CPU plain path (cube within 1e-5·max|rf|)")
    del got, want
    ppipe = RadarPipeline(cfg, device=dev, impl="pallas")
    ppipe.process_recording(s_raw, s_cal)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer = StageTimer()
    _lib.reset_launches()
    t0 = time.perf_counter()
    pout = ppipe.process_recording(raw, calib, timer=timer)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    p_launches = dict(_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    ppipe.run_chain(raw, calib)
    torch.cuda.synchronize()
    chain_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[pallas] process_recording impl='pallas' {FRAMES} frames: "
          f"{seconds:.4f} s = {FRAMES / seconds:,.0f} frames/s end to end; peak "
          f"device memory {peak:.2f} GiB, {chain_peak:.2f} GiB in the frame "
          "chain alone (its 2 GiB range-FFT cube included)")
    print(timer.pretty())
    print(f"[pallas] launches {p_launches}")
    for name in ("fast_time", "search_peaks_fused", "psd_phase1", "db_rescale"):
        check(p_launches[name] > 0, f"{name} launched on the impl='pallas' path")
    check(p_launches["fast_time_profile"] == 0, "K1 not launched on impl='pallas'")
    det = pout.detected
    check(np.array_equal(det, present), "pallas: detected frames = target frames")
    check(np.all(pout.target_range[0, det] == want_range)
          and np.all(np.isnan(pout.target_range[0, ~det]))
          and np.all(pout.target_speed[0, det] == want_speed),
          f"pallas: ranges = {want_range}, speeds = {want_speed}")
    # impl "pallas" is exact float32 (K6), the default impl bf16x3 (K1a).
    w_snr = snr_db(main_waterfall, pout.waterfall)
    check(w_snr >= 100.0, f"pallas: the default impl's waterfall {w_snr:.2f} dB")
    print(f"[pallas] range {want_range} m and speed {want_speed} m/s in all "
          f"{int(det.sum())} detected frames; the default impl's waterfall "
          f"{w_snr:.2f} dB SNR against it (tol 100 dB)")
    del pout, main_waterfall, ppipe
    torch.cuda.empty_cache()

    # 5b'. The plain formulations "fused", "xla", "fused_bf16" (plain
    # PyTorch, as the JAX package runs them in XLA): 256 frames against the
    # CPU plain path, then the production recording, counted (the export's
    # K2 and K3 only) and timed, held to the exact chain.
    for impl in ("fused", "xla", "fused_bf16"):
        ipipe = RadarPipeline(cfg, device=dev, impl=impl)
        got = ipipe.process_recording(s_raw, s_cal)
        want = RadarPipeline(cfg, device="cpu", impl=impl).process_recording(
            s_raw, s_cal)
        check(np.array_equal(got.detected, want.detected)
              and np.array_equal(got.target_range, want.target_range,
                                 equal_nan=True), f"{impl} small: detections, ranges")
        check(np.allclose(got.target_speed, want.target_speed, rtol=1e-6, atol=1e-7,
                          equal_nan=True), f"{impl} small: speeds")
        check(bool((np.abs(got.waterfall - want.waterfall)
                    <= 1e-2 + 1e-5 * np.abs(want.waterfall)).all()),
              f"{impl} small: waterfall within 1e-2 + 1e-5·|ref|")
        torch.cuda.synchronize()
        timer = StageTimer()
        _lib.reset_launches()
        t0 = time.perf_counter()
        iout = ipipe.process_recording(raw, calib, timer=timer)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        i_launches = dict(_lib.LAUNCHES)
        print(f"[{impl}] 256 frames on cuda match the CPU plain path; "
              f"process_recording {FRAMES} frames: {seconds:.4f} s = "
              f"{FRAMES / seconds:,.0f} frames/s end to end; launches {i_launches}")
        print(timer.pretty())
        check(i_launches == {k: int(k in ("psd_phase1", "db_rescale"))
                             for k in i_launches},
              f"impl={impl!r}: the export's K2 and K3 once, no frame-chain kernel")
        held_to_exact(f"impl={impl!r}", iout, xout, 0.001 if impl == "fused_bf16"
                      else 0.0)
        del iout, ipipe
        torch.cuda.empty_cache()
    del xout

    # 5b''. stft_impl="xla" on the production recording: the plain export
    # (operator product, float32 dB map, rescale, bf16 cast) after K1a. Its
    # bf16 intensity and the main path's (the kernels') are each held to
    # the kernel export at float32 intensity on the display band (0.15 dB
    # on clim [-40, 0]): two bf16 roundings of one value may lie a whole
    # ulp (0.25 dB at -40 dB) apart, each within half an ulp of it.
    scfg = RadarConfig.create(default_device_config(),
                              AlgorithmConfig.production(stft_impl="xla"))
    spipe = RadarPipeline(scfg, device=dev)
    spipe.process_recording(s_raw, s_cal)  # warm
    torch.cuda.synchronize()
    timer = StageTimer()
    _lib.reset_launches()
    t0 = time.perf_counter()
    sout = spipe.process_recording(raw, calib, timer=timer)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    s_launches = dict(_lib.LAUNCHES)
    print(f"[stft xla] process_recording stft_impl='xla' {FRAMES} frames: "
          f"{seconds:.4f} s = {FRAMES / seconds:,.0f} frames/s end to end; "
          f"launches {s_launches}")
    print(timer.pretty())
    check(s_launches == {k: int(k == "fast_time_profile_b3") for k in s_launches},
          "stft_impl='xla': K1a once, no export kernel")
    check(np.array_equal(sout.detected, present), "stft_impl='xla': detected frames")
    psd = torch.as_tensor(sout.spectrogram_psd_db)
    off_bf16 = int((psd.to(torch.bfloat16).float() != psd).sum())
    check(psd.dtype == torch.float32 and off_bf16 > 0,
          "stft_impl='xla': a float32 dB map (not bf16-quantized)")
    inten = sout.spectrogram_intensity
    chain_out = pipe.run_chain(raw, calib)
    signal, count_dev = pack_slow_time(chain_out.strongest_chirps,
                                       chain_out.detected, cfg.pn)
    _, _, ref = stc.spectrogram(pair_abs(signal).contiguous(), int(count_dev),
                                op, intensity_dtype=torch.float32)
    ref = ref[:, :inten.shape[1]].cpu().numpy()
    del chain_out, signal
    check(inten.shape == main_intensity.shape == ref.shape,
          "stft_impl='xla': intensity shape")
    band = (ref >= -40.0) & (ref <= 0.0)
    band_err = float(np.abs(inten - ref)[band].max())
    kern_err = float(np.abs(main_intensity - ref)[band].max())
    check(band_err <= 0.15 and kern_err <= 0.15,
          f"stft_impl='xla': intensity {band_err:.4g} dB (the kernels' "
          f"{kern_err:.4g}) of the float32 kernel export on clim [-40, 0] "
          "(tol 0.15)")
    print(f"[stft xla] dB map float32 ({off_bf16} of {psd.numel()} values off the "
          f"bf16 grid); bf16 intensity within {band_err:.4g} dB of the kernel "
          f"export at float32 intensity on clim [-40, 0] (the kernels' bf16 "
          f"intensity {kern_err:.4g}; tol 0.15 dB, {int(band.sum())} values)")
    del sout, spipe, psd, inten, band, main_intensity, ref

    # 5c. The recompute export K5a/K5b on the main path's own packed
    # |signal| (L = 1,048,576, nfft 256, nb_pad 136, float32 dB map): bit-
    # equal to K2/K3, each within K2/K3's bounds of its plain version.
    chain_out = pipe.run_chain(raw, calib)
    signal, count_dev = pack_slow_time(chain_out.strongest_chirps,
                                       chain_out.detected, cfg.pn)
    sig = pair_abs(signal).contiguous()
    count = int(count_dev)
    del chain_out, signal
    nv = count - 19
    nb_pad = -(-nb // 8) * 8
    a2 = torch.as_tensor(stc._folded_operator(op, 8), device=dev)
    torch.cuda.synchronize()
    _lib.reset_launches()
    _, db_r, int_r = stc.spectrogram(sig, count, op, recompute=True)
    torch.cuda.synchronize()
    k5_launches = dict(_lib.LAUNCHES)
    check(k5_launches["psd_tmax"] == 1 and k5_launches["db_rescale_recompute"] == 1
          and k5_launches["psd_phase1"] == 0 and k5_launches["db_rescale"] == 0,
          f"spectrogram(recompute=True) runs K5a and K5b only: {k5_launches}")
    _, db_m, int_m = stc.spectrogram(sig, count, op)
    check(torch.equal(db_r, db_m) and torch.equal(int_r, int_m),
          "spectrogram(recompute=True) bit-equal to spectrogram()")
    del db_r, int_r, db_m, int_m
    k5a_err, k5b_err = recompute_check(stc, DB_FLOOR, sig, nv, a2, nb, t_pad,
                                       tiled=False)
    f32, bf16 = torch.float32, torch.bfloat16

    def materializing():
        p, tmax = stc.psd_phase1(sig, nv, a2, nb_pad, t_pad)
        return stc.db_rescale(p, tmax.amax(), nb, 1024, f32, bf16)

    def recompute():
        gmax = stc.psd_tmax(sig, nv, a2, nb_pad, t_pad).amax()
        return stc.db_rescale_recompute(sig, nv, a2, gmax, nb, 1024, t_pad, bf16)

    def plain():
        p, tmax = stc.psd_phase1_ref(sig, nv, a2, nb_pad, t_pad)
        return stc.db_rescale_ref(p, tmax.amax(), nb, 1024, f32, bf16)

    export = time_turns({"K2+K3": materializing, "K5a+K5b": recompute,
                         "plain": plain})
    print(f"[time] export nfft 256, float32 dB, bf16 intensity: K2+K3 "
          f"{export['K2+K3']:.4f} ms, K5a+K5b {export['K5a+K5b']:.4f} ms, plain "
          f"{export['plain']:.4f} ms (in turns, median of {REPS})")
    ms5a, plain_ms5a, second5a = time_pair(
        lambda: stc.psd_tmax(sig, nv, a2, nb_pad, t_pad),
        lambda: stc.psd_tmax_ref(sig, nv, a2, nb_pad, t_pad))
    gmax_r = stc.psd_tmax(sig, nv, a2, nb_pad, t_pad).amax()
    ms5b, plain_ms5b, second5b = time_pair(
        lambda: stc.db_rescale_recompute(sig, nv, a2, gmax_r, nb, 1024, t_pad, bf16),
        lambda: stc.db_rescale_recompute_ref(sig, nv, a2, gmax_r, nb, 1024, t_pad,
                                             bf16))
    print(f"[time] K5a kernel {ms5a:.4f} ms, plain {plain_ms5a:.4f} ms; K5b "
          f"kernel {ms5b:.4f} ms, plain {plain_ms5b:.4f} ms (median of {REPS})")
    rows.append(dict(name="psd_tmax", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/stft_export.cu",
                     replaces="fmcw_radar_processing_tpu/ops/stft_pallas.py:158",
                     max_abs_err=k5a_err, ms=ms5a, plain_ms=plain_ms5a, ms_second=second5a,
                     bound=bound(sig.numel() * 4 + a2.numel() * 4
                                 + t_pad // stc.PSD_TILE * 4,
                                 psd_ops(nv, nb_pad), "f32")))
    rows.append(dict(name="db_rescale_recompute", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/stft_export.cu",
                     replaces="fmcw_radar_processing_tpu/ops/stft_pallas.py:178",
                     max_abs_err=k5b_err, ms=ms5b, plain_ms=plain_ms5b, ms_second=second5b,
                     bound=bound(sig.numel() * 4 + a2.numel() * 4 + 1024 * 12 + 4
                                 + nb_pad * t_pad * 4 + 1024 * t_pad * 2,
                                 psd_ops(nv, nb_pad) + db_ops(t_pad, nb_pad),
                                 "f32")))
    del a2

    # 5d. The recompute export past K5's shared memory: nfft 1,000 (nb 501,
    # nb_pad 504) on the same packed |signal|, where spectrogram(recompute=
    # True) takes the bin-blocked recompute pair, bit-equal to K4a → K4b.
    r_op = StftOperator.create(window_length=20, beta=3.0, nfft=1_000,
                               fs=1.0 / cfg.derived.prt)
    r_nb = r_op.num_bins
    r_nb_pad = -(-r_nb // 8) * 8
    check(stc.UNTILED_MAX_BINS < r_nb_pad <= stc.RECOMPUTE_MAX_BINS,
          f"nb_pad {r_nb_pad} is the bin-blocked recompute's domain")
    r_a2 = torch.as_tensor(stc._folded_operator(r_op, 8), device=dev)
    torch.cuda.synchronize()
    _lib.reset_launches()
    _, db_r, int_r = stc.spectrogram(sig, count, r_op, intensity_dtype=bf16,
                                     recompute=True)
    torch.cuda.synchronize()
    kt_launches = dict(_lib.LAUNCHES)
    pair = ("psd_tmax_tiled", "db_rescale_recompute_tiled")
    check(kt_launches == {k: int(k in pair) for k in kt_launches},
          f"spectrogram(recompute=True) at nfft 1000 runs {pair} once each "
          f"and nothing else: {kt_launches}")
    _, db_m, int_m = stc.spectrogram(sig, count, r_op, intensity_dtype=bf16)
    check(torch.equal(db_r, db_m) and torch.equal(int_r, int_m),
          "spectrogram(recompute=True) at nfft 1000 bit-equal to spectrogram()")
    print(f"[recompute] nfft {r_op.nfft} (nb_pad {r_nb_pad}) on the packed "
          f"signal (L={sig.shape[0]}): launches {kt_launches}; db "
          f"{tuple(db_r.shape)} and intensity {tuple(int_r.shape)} bit-equal "
          "to spectrogram() (K4a → K4b)")
    del db_r, int_r, db_m, int_m
    kta_err, ktb_err = recompute_check(stc, DB_FLOOR, sig, nv, r_a2, r_nb, t_pad,
                                       tiled=True)

    def materializing_tiled():
        p, tmax = stc.psd_phase1_tiled(sig, nv, r_a2, r_nb_pad, t_pad)
        return stc.db_rescale_tiled(p, tmax.amax(), r_nb, 1024, f32, bf16)

    def recompute_tiled():
        gmax = stc.psd_tmax_tiled(sig, nv, r_a2, r_nb_pad, t_pad).amax()
        return stc.db_rescale_recompute_tiled(sig, nv, r_a2, gmax, r_nb, 1024,
                                              t_pad, bf16)

    export = time_turns({"K4a+K4b": materializing_tiled,
                         "recompute": recompute_tiled})
    print(f"[time] export nfft {r_op.nfft}, float32 dB, bf16 intensity: K4a+K4b "
          f"{export['K4a+K4b']:.4f} ms, tiled recompute pair "
          f"{export['recompute']:.4f} ms (in turns, median of {REPS})")
    msta, plain_msta, secondta = time_pair(
        lambda: stc.psd_tmax_tiled(sig, nv, r_a2, r_nb_pad, t_pad),
        lambda: stc.psd_tmax_ref(sig, nv, r_a2, r_nb_pad, t_pad))
    gmax_r = stc.psd_tmax_tiled(sig, nv, r_a2, r_nb_pad, t_pad).amax()
    mstb, plain_mstb, secondtb = time_pair(
        lambda: stc.db_rescale_recompute_tiled(sig, nv, r_a2, gmax_r, r_nb, 1024,
                                               t_pad, bf16),
        lambda: stc.db_rescale_recompute_ref(sig, nv, r_a2, gmax_r, r_nb, 1024,
                                             t_pad, bf16))
    print(f"[time] psd_tmax_tiled kernel {msta:.4f} ms, plain {plain_msta:.4f} "
          f"ms; db_rescale_recompute_tiled kernel {mstb:.4f} ms, plain "
          f"{plain_mstb:.4f} ms (nfft {r_op.nfft}, median of {REPS})")
    r_blocks = -(-r_nb_pad // stc.BIN_BLOCK)
    rows.append(dict(name="psd_tmax_tiled", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/stft_export_tiled.cu",
                     replaces="fmcw_radar_processing_tpu/ops/stft_pallas.py:158",
                     max_abs_err=kta_err, ms=msta, plain_ms=plain_msta,
                     ms_second=secondta,
                     bound=bound(sig.numel() * 4 + r_a2.numel() * 4
                                 + r_blocks * t_pad // stc.PSD_TILE * 4,
                                 psd_ops(nv, r_nb_pad), "f32")))
    rows.append(dict(name="db_rescale_recompute_tiled", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/stft_export_tiled.cu",
                     replaces="fmcw_radar_processing_tpu/ops/stft_pallas.py:178",
                     max_abs_err=ktb_err, ms=mstb, plain_ms=plain_mstb,
                     ms_second=secondtb,
                     bound=bound(sig.numel() * 4 + r_a2.numel() * 4 + 1024 * 12
                                 + (r_blocks + 1) * 4 + 4
                                 + r_nb_pad * t_pad * 4 + 1024 * t_pad * 2,
                                 psd_ops(nv, r_nb_pad) + db_ops(t_pad, r_nb_pad),
                                 "f32")))
    del sig, r_a2
    torch.cuda.empty_cache()

    # 6. The fidelity profile — the bare AlgorithmConfig, the service's
    # default — whose nfft = 2^nextpow2(count) takes K4 past 512 bins.
    fcfg = RadarConfig.create(default_device_config())
    fpresent = present[:FIDELITY_FRAMES]
    frec = synthesize_recording(fcfg, FIDELITY_FRAMES, (strong, weak),
                                seed=SEED + 2, target_present=fpresent)
    f_raw = to_pair(frec.rx1()).reshape(FIDELITY_FRAMES, cfg.pn, 2 * cfg.nts)
    f_cal = to_pair(frec.calib_vector(0, cfg.nts))
    fpipe = RadarPipeline(fcfg, device=dev)

    # 6a. Its first 128 frames (nfft 2,048) on the card against the CPU
    # plain path, with the fidelity tolerances of the CPU tests.
    got = fpipe.process_recording(f_raw[:128], f_cal)
    want = RadarPipeline(fcfg, device="cpu").process_recording(f_raw[:128], f_cal)
    check(np.array_equal(got.detected, want.detected), "fidelity small: detected")
    check(np.array_equal(got.target_range, want.target_range, equal_nan=True),
          "fidelity small: ranges")
    check(np.array_equal(got.target_speed, want.target_speed, equal_nan=True),
          "fidelity small: speeds")
    check(got.spectrogram_psd_db.shape[0] == 1025, "fidelity small: nfft 2048")
    for name, tol in (("spectrogram_psd_db", 1e-3), ("spectrogram_intensity", 2e-3)):
        a, b = getattr(got, name), getattr(want, name)
        check(a.shape == b.shape, f"fidelity small: {name} shape")
        band, deep = b > -40, b > -120
        check(float(np.abs(a - b)[band].max()) <= tol
              and float(np.abs(a - b)[deep].max()) <= 0.2
              and np.array_equal(a == DB_FLOOR, b == DB_FLOOR),
              f"fidelity small: {name} within {tol} dB above -40 dB, 0.2 dB "
              "above -120 dB, floors equal")
    print("[fidelity small] 128-frame fidelity recording (nfft 2048) on cuda "
          "matches the CPU plain path")

    # 6b. The fidelity main path: 1,024 frames, nfft 16,384, counted and timed.
    torch.cuda.synchronize()
    timer = StageTimer()
    _lib.reset_launches()
    t0 = time.perf_counter()
    fout = fpipe.process_recording(f_raw, f_cal, timer=timer)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    f_launches = dict(_lib.LAUNCHES)
    print(f"[fidelity] process_recording {FIDELITY_FRAMES} frames: "
          f"{seconds:.4f} s = {FIDELITY_FRAMES / seconds:,.1f} frames/s end to end")
    print(timer.pretty())
    print(f"[fidelity] launches {f_launches}")
    for name in ("fast_time_profile_b3", "psd_phase1_tiled", "db_rescale_tiled"):
        check(f_launches[name] > 0, f"{name} launched on the fidelity path")
    for name in ("fast_time_profile", "psd_phase1", "db_rescale", "psd_tmax_tiled",
                 "db_rescale_recompute_tiled"):
        check(f_launches[name] == 0, f"{name} not launched on the fidelity path")
    det = fout.detected
    check(np.array_equal(det, fpresent), "fidelity: detected frames = target frames")
    check(np.all(fout.target_range[0, det] == want_range)
          and np.all(fout.target_speed[0, det] == want_speed),
          f"fidelity: ranges = {want_range}, speeds = {want_speed}")
    n_valid = int(det.sum()) * cfg.pn - 19
    inten, psd = fout.spectrogram_intensity, fout.spectrogram_psd_db
    check(inten.shape == (1024, n_valid) and psd.shape == (8193, n_valid),
          "fidelity: spectrogram shapes (nfft 16384)")
    check(bool(np.isfinite(inten).all()), "fidelity: intensity finite")
    check(float(psd.max()) == 0.0 and bool((psd >= DB_FLOOR).all()),
          "fidelity: dB map normalized to 0 dB and floored at DB_FLOOR")
    check(not (psd == DB_FLOOR).all(axis=0).any(), "fidelity: no floored column")
    print(f"[fidelity] range {want_range} m and speed {want_speed} m/s in all "
          f"{int(det.sum())} detected frames; intensity {inten.shape} finite, "
          f"dB map {psd.shape} max 0, no floored column")
    del fout, inten, psd, f_raw, frec

    # 7. The service: three requests on a 256-frame recording.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        blobs, work = os.path.join(tmp, "blobs"), os.path.join(tmp, "work")
        os.makedirs(work)
        store = LocalStorage(blobs)
        xml, bin_ = write_recording(os.path.join(tmp, "radar_data"), small)
        store.put(xml, "radar_data.xml")
        store.put(bin_, "radar_data.raw.bin")
        svc = RadarService(HandlerConfig(profile="production", workdir=work,
                                         storage_spec=f"local:{blobs}",
                                         pretty_json=False))
        for i in range(3):
            serve_no(svc, work, want_range, f"production request {i}")
        print(f"[serve] 3/3 requests succeeded; ranges {float(want_range)} m")

        # The service's default profile (fidelity: nfft 4,096 for "no", 2,048
        # and 1,024 for the activity batches — K4), then a production "yes".
        fwork = os.path.join(tmp, "work_default")
        os.makedirs(fwork)
        fsvc = RadarService(HandlerConfig(workdir=fwork, pretty_json=False,
                                          storage_spec=f"local:{blobs}"))
        check(fsvc.config.profile == "fidelity", "the default profile is fidelity")
        for i in range(3):
            serve_no(fsvc, fwork, want_range, f"default request {i}")
        detected = present[:256]  # the 256-frame recording's target frames
        for i in range(2):
            serve_yes(fsvc, fwork, detected, cfg.pn, f"default activity request {i}")
        serve_yes(svc, work, detected, cfg.pn, "production activity request")
        print('[serve] default profile: 3/3 "no" and 2/2 "yes" requests '
              'succeeded (3 batch JSONs each); production: 1/1 "yes"')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 8. The persistent service path at full size: the streaming processor,
    # VGG16 inference, and the HTTP service with /classify and the
    # dashboard.
    stream_phase(dev, cfg, _lib)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_svc_")
    try:
        clf = classify_phase(dev, tmp)
        service_phase(dev, tmp, small, clf["artifact"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # Launches of each kernel on the main path that drives it (the row's
    # "launches", that path named in "main_path"): the production
    # run for K1a, K2, K3, the impl "pallas_profile" run for K1b, the
    # impl "pallas_profile_bf16" run for K1c, the
    # fidelity run for K4a/K4b, the impl "pallas" run for K6/K7,
    # spectrogram(recompute=True) for K5a/K5b and, at nfft 1,000, for the
    # bin-blocked recompute pair.
    paths = {"fast_time_profile_b3": ("production", launches),
             "fast_time_profile_bf16": ("production impl='pallas_profile_bf16'",
                                        b_launches),
             "fast_time_profile": ("production impl='pallas_profile'", x_launches),
             "psd_phase1": ("production", launches),
             "db_rescale": ("production", launches),
             "psd_phase1_tiled": ("fidelity", f_launches),
             "db_rescale_tiled": ("fidelity", f_launches),
             "fast_time": ("production impl='pallas'", p_launches),
             "search_peaks_fused": ("production impl='pallas'", p_launches),
             "psd_tmax": ("spectrogram(recompute=True)", k5_launches),
             "db_rescale_recompute": ("spectrogram(recompute=True)", k5_launches),
             "psd_tmax_tiled": ("spectrogram(recompute=True) nfft 1000",
                                kt_launches),
             "db_rescale_recompute_tiled": ("spectrogram(recompute=True) nfft 1000",
                                            kt_launches)}
    table = []
    for r in rows:
        path, counts = paths[r["name"]]
        check(counts[r["name"]] > 0, f"{r['name']} launched on its path ({path})")
        table.append(dict(
            name=r["name"], route=r["route"], source=r["source"],
            replaces=r["replaces"], launches=counts[r["name"]], main_path=path,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            ms_second_in_turn=r["ms_second"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1], library_ms=None,
            library_note=NO_LIBRARY))
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
