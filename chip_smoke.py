"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--parent DIR]
    python3 chip_smoke.py --parallel-cards N

``--parallel-cards N`` runs only the parallel paths, on N cards under
NCCL, one card a rank (:func:`parallel_cards_phase`); without an option
it runs everything below on one card.

Builds the CUDA kernels from ``fmcw_radar_processing_tpu_torch/csrc``
and holds each against its plain PyTorch version, timing both: K1a (the
bf16x3 profile on the tensor cores, also held to the exact profile at
100 dB), K1c (one bf16 pass on the tensor cores, at 45 dB), K1b (six bf16
passes on the tensor cores, the TPU's HIGHEST, also held to the exact
profile at 120 dB), K6 (K1b with the range FFT stored too, its profile
bit-equal to K1b's, its cube within 1e-5·max|rf| of the exact one) and K7
(the
fused peak search, T = 1 and 3) at the shapes of the production recording
path (65,536 frames of 16 chirps × 64 samples), K2a (the bf16x3 PSD on the
tensor cores, also held to the exact PSD at 100 dB and through K3 on the
display band), K2b (the exact PSD, K4a's kernel) and K3 there at STFT nfft
256, the bf16 PSD store's rounding flag of K2a, K2b and K4a, K3 and K5b at
nfft 430 and 512 (K3's 64-column tiles, K5b's 128), K4a/K4b at the
fidelity profile's shape (1,024 frames, nfft 16,384)
and at 65,536 columns of nfft 65,536, where offsets pass 2^31. Then it
drives the main paths, each with the launch counters reset just before
and read just after: ``RadarPipeline.process_recording`` under the
production profile on a 65,536-frame synthetic recording with the default
impl (K1a, K2a, K3), with impl "pallas" (K6, K7, K2a, K3), with the exact
chain (impl "pallas_profile", stft_psd_precision "highest": K1b, K2b, K3)
and with stft_psd_store "bfloat16" (K1a, K2a rounding, K3), the recompute
export ``spectrogram(recompute=True)`` on that run's packed signal (K5a,
K5b, bit-equal to K2b/K3) and on the same signal at nfft 1,000 (nb_pad 504:
the bin-blocked recompute pair psd_tmax_tiled/db_rescale_recompute_tiled,
bit-equal to K4a/K4b), the fidelity profile on a 1,024-frame recording
(K1a, K4a, K4b), checking the detections against the injected targets.
The production recording also runs with impl "pallas_profile_bf16" (K1c,
K2a, K3), held
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
once (coalesced) and at 1, 8 and 64 images. Then [train] the classifier's
training path: VGG16 at 224×224×3, batch 32, bf16 compute, Adam 1e-4,
augmentation on the card, with a frozen backbone and in full (step time
by CUDA events, images/s, peak memory; the frozen backbone bit-unchanged,
the head moved), one float32 dropout-off step held to the same step on
the CPU, the JAX test's toy ``run_classifier_experiment`` (its images
made by the chain, K1a, K4a and K4b counted once a recording; final
train accuracy at least 0.8; the round trip served from the port's
artifact) and a two-point robustness sweep. Then [parallel] the
parallel paths of parallel/ through entry.py::dryrun_multichip, each held
on every rank to the single-device chain: world 1 under NCCL at 65,536
frames (the dp chain, bit-equal; the sp recording against RadarPipeline;
a Trainer step), then worlds 2 and 4 under gloo with every rank on the
one card, at 8,192 frames (dp, tp, pp, the sharded STFT, the sp
recording, the multihost feed, streaming over the mesh, a Trainer step),
K1a counted on every rank; the native reader behind
load_recording_for_chain; a ``process --trace-dir`` trace that names
K1a's kernel, and the same command in the smoke's own process with K1a
counted. Then [precision]: the SNR ladder (tools/snr_ladder.py) at
matmul_precision "default", "high" and "highest" on the card with its
checks; the production recording under stft_impl="xla" at each precision
(detections identical, K1a once each, SNR and display-band error against
"highest", wall time, peak memory); and the default production path
bit-equal with the precision plumbing bypassed. It prints a kernel
table and a device line as JSON. Each
kernel row has its time (``ms``: the first of two timed runs in each
turn, right after its plain version; the second, right after itself, is
``ms_second_in_turn``; ``ms_back_to_back`` is the
time a call takes among 50 made back to back, the kernel time with the
wrapper's host work hidden — K7's on two copies of its profile in turn,
so that no call finds it in L2 — and K7's row has torch.profiler's
device time of its kernel), its plain version's time,
its launches on the path that drives it, and its bound: the larger
of the bytes it must move over 3.35 TB/s and its operations over the peak
of their type (989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32),
the published H100 SXM figures; the operations of K1a and K1b/K6 are the
bf16 passes they run (three and six products). With ``--parent DIR``, the
K1c and K7 of another checkout at DIR (its sources built here, its
wrappers loaded under other names) are held to this one's outputs and
timed against them in turns and back to back (parent, change, change,
parent); their rows then carry both readings. Any failed check raises, so
the exit code is non-zero. There is no CPU path: without a CUDA device it
exits at once.
"""

from __future__ import annotations

import contextlib
import ctypes
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
B2B_CALLS = 50  # calls a back-to-back reading averages
WIDE_REPS = 5  # timing runs at the 65,536-column, nfft 65,536 shape
# [stream]: bench.py's 5_streaming_8ch (production profile, nfft 256).
STREAM_CHANNELS = 8
STREAM_WINDOW = 256  # frames per window and channel
STREAM_WINDOWS = 4  # windows of the 1,024-frame recording
STREAM_TIMED = 20  # timed steady-state windows per mode and input
VGG_SHAPE = (224, 224, 3)
VGG_BATCHES = (1, 8, 64)
# [parallel]: worlds 2 and 4 run under gloo, which stages every collective
# through the host; the sp export gathers its [1024, L] float32 intensity
# on every rank (0.48 GB at 8,192 frames, 3.9 GB at 65,536).
PAR_FRAMES = 8_192
# K1a's launches per rank on each path of entry.py::run_multichip_checks:
# once a chain call; streaming runs 2 windows × 2 channels a rank.
K1A_PER_PATH = {"dp": 1, "sp": 1, "multihost": 1, "tp": 0, "pp": 0, "stft": 0,
                "train": 0, "stream": 4}
# The worker of the true multi-process run (multihost.initialize).
ROOT = os.path.dirname(os.path.abspath(__file__))
MULTIHOST_WORKER = os.path.join(ROOT, "tests", "_torch_multihost_worker.py")
# [train]: the notebook's transfer setup (cell 17: batch 32; cell 19: Adam
# 1e-4), then the JAX test's toy experiment (test_experiment.py:60-75).
TRAIN_BATCH = 32
TRAIN_WARMUP = 3
TRAIN_TIMED = 10
TRAIN_CHECK_BATCH = 4  # the float32, dropout-off step held to the CPU
TOY_EXPERIMENT = dict(images_per_class=10, frames_per_recording=48,
                      image_size=(64, 64), model="small", epochs=30,
                      batch_size=7, learning_rate=1e-3, augment=False,
                      render_size=(320, 240))
# The chain's kernels of the bare AlgorithmConfig at 48 frames (nfft 1,024,
# nb_pad past 272): K1a, then K4a and K4b, once a recording.
CHAIN_KERNELS = ("fast_time_profile_b3", "psd_phase1_tiled", "db_rescale_tiled")
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


def time_back_to_back(fn, n: int = B2B_CALLS) -> float:
    """Milliseconds a call of ``fn`` takes on the card when calls follow
    each other: after a warmup, one event, ``n`` calls back to back, one
    event, then the elapsed time over ``n``. The host enqueues ahead of the
    card, so its work between launches hides and the reading is the
    kernel's time; a wrapper whose host work outlasts its kernel shows
    that work instead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / n


def time_pair(kernel, plain, reps: int = REPS) -> tuple[float, float, float, float]:
    """Median CUDA-event milliseconds of a kernel and its plain version, in
    turns, the kernel's second-in-turn median (see time_turns), and its
    back-to-back time (time_back_to_back)."""
    second: dict[str, float] = {}
    t = time_turns({"kernel": kernel, "plain": plain}, reps, second)
    return t["kernel"], t["plain"], second["kernel"], time_back_to_back(kernel)


def alternate(fn, inputs):
    """A callable that runs ``fn`` on each of ``inputs`` in turn."""
    state = {"i": 0}

    def run():
        state["i"] += 1
        return fn(inputs[state["i"] % len(inputs)])

    return run


def profiler_kernel_ms(fn, name_part: str, n: int = 20) -> float | None:
    """Mean device milliseconds of the kernels whose name holds
    ``name_part`` over ``n`` calls of ``fn``, as torch.profiler's
    key_averages() reports them; None when it shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for e in prof.key_averages():
        if name_part in e.key:
            total += getattr(e, "device_time_total", None) or getattr(
                e, "cuda_time_total", 0.0)
            count += e.count
    return total / count / 1e3 if count and total else None


def load_parent(root: str):
    """The K1c and K7 wrappers of another checkout of the port at ``root``
    (its ``ops/fast_time_cuda.py`` and ``ops/detect_cuda.py``, loaded under
    other module names), bound to a library built from its
    ``fast_time_wgmma.cu`` and ``detect.cu`` with this port's nvcc flags.
    Their launches count nowhere."""
    import ctypes
    import importlib.util
    import types

    from fmcw_radar_processing_tpu_torch.ops import _lib

    pkg = os.path.join(root, "fmcw_radar_processing_tpu_torch")
    work = tempfile.mkdtemp(prefix="parent_kernels_")
    nvcc = _lib.find_nvcc()
    srcs = ("fast_time_wgmma.cu", "detect.cu")
    objs = [os.path.join(work, src + ".o") for src in srcs]
    procs = [subprocess.Popen([nvcc, *_lib.NVCC_FLAGS, "-c", "-o", obj,
                               os.path.join(pkg, "csrc", src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for src, obj in zip(srcs, objs)]
    for src, proc in zip(srcs, procs):
        _, err = proc.communicate()
        check(proc.returncode == 0, f"parent build of {src}: {err[-2000:]}")
    so = os.path.join(work, "libparent_kernels.so")
    subprocess.run([nvcc, "-shared", "-o", so, *objs], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, args in (("fast_time_profile_bf16_launch", [p, p, p, p, i, i, p]),
                       ("search_peaks_launch", [p, p, f, i, i, i, p, p, p, p])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i

    def launched(name, rc):
        check(rc == 0, f"parent {name} launch: CUDA error {rc}")

    shim = types.SimpleNamespace(load_kernels=lambda: lib,
                                 check_operand=_lib.check_operand,
                                 check_launch=launched)
    mods = []
    for name in ("fast_time_cuda", "detect_cuda"):
        spec = importlib.util.spec_from_file_location(
            f"parent_{name}", os.path.join(pkg, "ops", name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod._lib = shim
        mods.append(mod)
    print(f"[parent] K1c and K7 of {root} built and loaded")
    return tuple(mods)


def parent_turns(what: str, parent_fn, change_fn, inputs, agree) -> dict:
    """A kernel of the parent checkout against this one on the same
    inputs: their outputs held to each other by ``agree``, CUDA-event
    readings in turns (parent, then change, each twice in its turn), then
    back to back in the order parent, change, change, parent (each call on
    the next of ``inputs``)."""
    check(agree(parent_fn(inputs[0]), change_fn(inputs[0])),
          f"{what}: the parent's output agrees with the change's")
    second: dict[str, float] = {}
    first = time_turns({"parent": alternate(parent_fn, inputs),
                        "change": alternate(change_fn, inputs)}, REPS, second)
    b2b = [time_back_to_back(alternate(fn, inputs))
           for fn in (parent_fn, change_fn, change_fn, parent_fn)]
    print(f"[parent] {what}: outputs agree; back to back parent {b2b[0]:.4f}, "
          f"change {b2b[1]:.4f}, change {b2b[2]:.4f}, parent {b2b[3]:.4f} ms "
          f"({B2B_CALLS} calls); in turns first {first['parent']:.4f} (parent) "
          f"vs {first['change']:.4f} (change), second {second['parent']:.4f} vs "
          f"{second['change']:.4f} ms (median of {REPS}); back-to-back speed-up "
          f"{(b2b[0] + b2b[3]) / (b2b[1] + b2b[2]):.3f}x")
    return {"parent_ms_back_to_back": [b2b[0], b2b[3]],
            "change_ms_back_to_back": [b2b[1], b2b[2]],
            "parent_ms": first["parent"], "parent_ms_second_in_turn": second["parent"],
            "change_ms": first["change"], "change_ms_second_in_turn": second["change"]}


def k7_widths_check(dtc, dev, frames: int = FRAMES) -> None:
    """K7 at K 128, 512 and 1024 on profiles of ``frames`` rows of seeded
    noise with 1% of bins at one value (peaks that tie): at T 1 and 3 with
    the production gate and at T 3 with an empty gate (min_distance above
    the range), idx, magnitude and valid equal to the plain version."""
    from fmcw_radar_processing_tpu_torch import (
        AlgorithmConfig,
        RadarConfig,
        default_device_config,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    for k in (128, 512, 1024):
        prof = torch.rand((frames, k), generator=gen, device=dev) * 400.0
        prof[torch.rand((frames, k), generator=gen, device=dev) < 0.01] = 600.0
        r_max = 48.0  # default_device_config's range
        for t, gate in ((1, {}), (3, {}),
                        (3, dict(min_distance=r_max + 1.0, max_distance=r_max + 2.0))):
            c = RadarConfig.create(default_device_config(), AlgorithmConfig.production(
                range_fft_size=k, max_num_targets=t, **gate))
            got = dtc.search_peaks_fused(prof, c)
            want = dtc.search_peaks_fused_ref(prof, c)
            same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
            n_valid = int(got.valid.sum())
            ok = all(same) and (n_valid == 0 if gate else n_valid > 0)
            print(f"[parity] K7 search_peaks_fused ({frames}, {k}) T={t}, "
                  f"{'an empty gate' if gate else 'the production gate'}: idx, "
                  f"magnitude, valid equal {same}; {n_valid} valid of "
                  f"{got.valid.numel()} slots {'ok' if ok else 'FAIL'}")
            check(ok, f"K7 parity at K {k}, T {t}")
        del prof, got, want
    torch.cuda.empty_cache()


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


def b3_ops(columns: int, nb_pad: int) -> float:
    """bf16 operations of K2a's products over ``columns`` valid windows: three
    passes of the [2·nb_pad, 20] operator times a 20-sample window."""
    return 3.0 * 2 * (2 * nb_pad) * 20 * columns


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
    (nb_pad above 208: at nfft 430 nb_pad 216 with the float32 dB map, 224
    with the bf16 one; at nfft 512 264 and 272), so it runs 64-column
    tiles. Every store dtype against the plain version; with the float32
    dB map, K5b (still on 128-column tiles there) bit-equal."""
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


def train_steps(dev, freeze: bool, batch: int = TRAIN_BATCH,
                warmup: int = TRAIN_WARMUP, timed: int = TRAIN_TIMED) -> dict:
    """VGG16 at 224×224×3 (bf16 compute, float32 parameters), Adam 1e-4,
    augmentation on the card: ``warmup`` steps, then ``timed`` steps each
    between two CUDA events (augmentation, forward, backward, optimizer).
    Checks finite losses, the frozen backbone bit-unchanged (or, trained,
    moved) and the head moved."""
    from fmcw_radar_processing_tpu_torch.models.data import augment_batch
    from fmcw_radar_processing_tpu_torch.models.train import (
        TrainConfig,
        Trainer,
        make_train_step,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)  # by the earlier phases
    trainer = Trainer("vgg16", TrainConfig(learning_rate=1e-4,
                                           freeze_backbone=freeze,
                                           batch_size=batch),
                      input_shape=VGG_SHAPE, device=dev)
    step = make_train_step(trainer.model, trainer.optimizer)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    x = torch.rand((batch, *VGG_SHAPE), generator=gen, device=dev)
    y = (torch.arange(batch, device=dev) % 2).to(torch.float32)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}

    def run():
        return step(augment_batch(trainer.aug_generator, x), y,
                    trainer.drop_generator)["loss"]

    losses = [run() for _ in range(warmup)]
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(timed)]
    for start, stop in events:
        start.record()
        losses.append(run())
        stop.record()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in events]
    peak = torch.cuda.max_memory_allocated(dev)
    losses = torch.stack(losses).float().cpu().numpy()
    after = trainer.model.state_dict()
    moved = {k: not torch.equal(v, after[k]) for k, v in before.items()}
    what = "frozen" if freeze else "full"
    check(bool(np.isfinite(losses).all()), f"[train] {what}: losses finite")
    check(all(moved[k] for k in moved if k.startswith("head.")),
          f"[train] {what}: every head parameter moved")
    backbone = [moved[k] for k in moved if k.startswith("backbone.")]
    if freeze:
        check(not any(backbone), "[train] frozen: backbone bit-unchanged")
    else:
        check(all(backbone), "[train] full: every backbone parameter moved")
    med = statistics.median(ms)
    n_train = sum(p.numel() for p in trainer.optimizer.params)
    print(f"[train] VGG16 {VGG_SHAPE} batch {batch}, {what} "
          f"({n_train:,} trainable parameters): step median {med:.3f} ms "
          f"(min {min(ms):.3f}, max {max(ms):.3f}; CUDA events, {timed} steps "
          f"after {warmup}), {batch / (med / 1e3):,.1f} images/s, "
          f"max_memory_allocated {peak / 2**30:.3f} GiB ({held / 2**30:.3f} "
          f"GiB of it held before the trainer was built); loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; "
          + ("backbone bit-unchanged, head moved" if freeze
             else "backbone and head moved"))
    del trainer, step, x, before, after
    return {"step_ms": med, "steps_ms": ms, "images_s": batch / (med / 1e3),
            "max_memory_allocated": peak, "held_before": held,
            "loss_first": float(losses[0]),
            "loss_last": float(losses[-1])}


def train_card_vs_cpu(dev, batch: int = TRAIN_CHECK_BATCH) -> dict:
    """One float32 step, dropout off, at ``batch`` on the card and on the
    CPU from the same parameters and batch (TF32 off). Two float32 sum
    orders send a few pre-activations to the other side of a ReLU or a
    max-pool, so the early layers' gradients differ by percent: the CPU's
    own float32 step at this shape differs from a float64 step by at most
    2.0e-2 of a leaf's L2 norm, and its Adam step by more than 1e-2·lr on
    0.6% of the elements (measured on the CPU). Tolerances: loss within
    1e-5 (relative); each gradient leaf within 5e-2 of its L2 norm; every
    parameter within 2·lr (Adam's first step is lr·g/(|g| + ε): a gradient
    near rounding may take the other sign) and at most 2% of them off by
    more than 1e-2·lr."""
    from fmcw_radar_processing_tpu_torch.models.train import (
        TrainConfig,
        Trainer,
        make_train_step,
    )

    lr = 1e-4
    cfg = TrainConfig(learning_rate=lr, augment=False)
    card = Trainer("vgg16", cfg, input_shape=VGG_SHAPE, device=dev,
                   dtype=torch.float32)
    cpu = Trainer("vgg16", cfg, input_shape=VGG_SHAPE, device="cpu",
                  dtype=torch.float32)
    cpu.set_params(card.params)
    x = np.random.default_rng(SEED + 7).uniform(
        0, 1, (batch, *VGG_SHAPE)).astype(np.float32)
    y = (np.arange(batch) % 2).astype(np.float32)
    out = {}
    for name, t in (("card", card), ("cpu", cpu)):
        t.model.head.dropout = 0.0
        loss = make_train_step(t.model, t.optimizer)(
            torch.as_tensor(x).to(t.device), torch.as_tensor(y).to(t.device),
            None)["loss"]
        out[name] = (float(loss), {k: (p.detach().cpu(), p.grad.cpu())
                                   for k, p in t.model.named_parameters()})
    (l_card, s_card), (l_cpu, s_cpu) = out["card"], out["cpu"]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    grad_l2 = step_max = 0.0
    far = total = 0
    for k, (p_cpu, g_cpu) in s_cpu.items():
        p_card, g_card = s_card[k]
        grad_l2 = max(grad_l2, float((g_card - g_cpu).norm() / g_cpu.norm()))
        d = (p_card - p_cpu).abs()
        step_max = max(step_max, float(d.max()) / lr)
        far += int((d > 1e-2 * lr).sum())
        total += d.numel()
    print(f"[train] one float32 step, dropout off, batch {batch}, card vs CPU: "
          f"loss {l_card:.7f} vs {l_cpu:.7f} (rel {loss_rel:.3g}, tol 1e-5); "
          f"gradients at most {grad_l2:.3g} of a leaf's L2 norm apart (tol "
          f"5e-2); parameters at most {step_max:.3g}·lr apart (tol 2), "
          f"{far / total:.3%} of them by more than 1e-2·lr (tol 2%)")
    check(loss_rel <= 1e-5 and grad_l2 <= 5e-2 and step_max <= 2.0 + 1e-3
          and far <= 2e-2 * total, "[train] card step = CPU step")
    del card, cpu, out, s_card, s_cpu
    return {"loss_rel": loss_rel, "grad_l2_rel": grad_l2,
            "param_over_lr": step_max, "param_far_share": far / total}


def train_phase(dev, tmp: str, lib) -> dict:
    """[train] the classifier's training path on the card: VGG16 steps at
    full width (frozen backbone and full), the card's step against the
    CPU's, the JAX test's toy run_classifier_experiment (its images made
    by the chain: K1a, K4a and K4b counted once a recording; its bar,
    final train accuracy ≥ 0.8; the round trip served from the port's
    artifact) and a tiny robustness sweep (two SNR points)."""
    from fmcw_radar_processing_tpu_torch.models.experiment import (
        ExperimentConfig,
        run_classifier_experiment,
    )
    from fmcw_radar_processing_tpu_torch.models.robustness import (
        run_robustness_sweep,
    )

    print(f"[train] card: {card_line()}")
    out = {"frozen": train_steps(dev, True), "full": train_steps(dev, False)}
    out["card_vs_cpu"] = train_card_vs_cpu(dev)
    torch.cuda.empty_cache()

    cfg = ExperimentConfig(**TOY_EXPERIMENT)
    recordings = 2 * cfg.images_per_class
    lib.reset_launches()
    report = run_classifier_experiment(os.path.join(tmp, "experiment"), cfg,
                                       device=dev)
    launches = {k: v for k, v in lib.LAUNCHES.items() if v}
    hist = report["training"]["history"]
    rt = report["serving_roundtrip"]
    print(f"[train] toy run_classifier_experiment ({cfg.images_per_class} "
          f"images a class, {cfg.frames_per_recording} frames, "
          f"{cfg.image_size}, {cfg.model}, {cfg.epochs} epochs, batch "
          f"{cfg.batch_size}): generation {report['dataset']['generation_seconds']}"
          f" s, training {report['training']['seconds']} s "
          f"({report['device']['step_seconds']} s a step, steady state); "
          f"final train accuracy {hist[-1]['accuracy']:.4f} (bar 0.8), val "
          f"{report['val']['accuracy']}, test {report['test']['accuracy']}; "
          f"round trip {rt['correct']}/{rt['sampled']} served from "
          f"{os.path.basename(rt['artifact'])}/params.npz; launches {launches} "
          f"for {recordings} recordings")
    check(hist[-1]["accuracy"] >= 0.8, "[train] toy experiment: train accuracy >= 0.8")
    check(rt["sampled"] == 2 and os.path.exists(
        os.path.join(rt["artifact"], "params.npz")), "[train] served round trip")
    check(report["device"]["device_kind"] == torch.cuda.get_device_name(dev),
          "[train] the experiment ran on the card")
    for name in CHAIN_KERNELS:
        check(launches.get(name) == recordings,
              f"[train] {name} launched once a recording")
    check(set(launches) == set(CHAIN_KERNELS), "[train] no other kernel launched")
    out["experiment"] = {"generation_s": report["dataset"]["generation_seconds"],
                         "training_s": report["training"]["seconds"],
                         "train_accuracy": hist[-1]["accuracy"],
                         "launches": launches}

    lib.reset_launches()
    sweep = run_robustness_sweep(
        os.path.join(tmp, "robustness"), model="small", train_images_per_class=4,
        test_images_per_class=2, frames_per_recording=48, epochs=2, batch_size=4,
        image_size=(64, 64), render_size=(320, 240), snr_grid_db=(30.0, 0.0),
        extra_conditions=False, device=dev)
    rows = sweep["rows"]
    row_keys = {"condition", "input_snr_db", "noise_sigma", "amp_scale",
                "overlap_ratio", "detection_rate", "accuracy", "loss", "n_images"}
    check(set(sweep) == {"model", "classes", "train_images_per_class",
                         "test_images_per_class", "epochs", "mixture_augment",
                         "mixture_frac", "mixture_ratio", "history_tail", "rows",
                         "break_snr_db", "snr_definition"}
          and [r["condition"] for r in rows] == ["snr_+30dB", "snr_+0dB"]
          and all(set(r) == row_keys for r in rows), "[train] sweep report schema")
    launches = {k: v for k, v in lib.LAUNCHES.items() if v}
    print("[train] robustness sweep (4 train and 2 test images a class, 48 "
          "frames, 2 epochs): " + "; ".join(
              f"{r['condition']} detection rate {r['detection_rate']}, accuracy "
              f"{r['accuracy']}" for r in rows) + f"; launches {launches}")
    out["robustness"] = {r["condition"]: r["detection_rate"] for r in rows}
    return out


def main_targets() -> tuple:
    """The main path's two targets, a strong and a weak one."""
    from fmcw_radar_processing_tpu_torch import SyntheticTarget

    return (SyntheticTarget(range_m=7.5, doppler_bin_offset=3, amplitude=4.0),
            SyntheticTarget(range_m=16.9, doppler_bin_offset=-2, amplitude=2.0))


def production_recording(cfg, rng: np.random.Generator
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The main path's input: FRAMES frames of :func:`main_targets` (seed
    SEED), about MUTED_SHARE of them muted, drawn from ``rng``, so that
    slow-time packing is not the identity. Returns (raw [F, PN, 2·NTS],
    calib [NTS, 2], the frames with targets)."""
    from fmcw_radar_processing_tpu_torch import synthesize_recording
    from fmcw_radar_processing_tpu_torch.utils.cplx import to_pair

    present = rng.random(FRAMES) >= MUTED_SHARE
    t0 = time.perf_counter()
    rec = synthesize_recording(cfg, FRAMES, main_targets(), seed=SEED,
                               target_present=present)
    raw = to_pair(rec.rx1()).reshape(FRAMES, cfg.pn, 2 * cfg.nts)
    calib = to_pair(rec.calib_vector(0, cfg.nts))
    print(f"[setup] synthesized {FRAMES} frames in "
          f"{time.perf_counter() - t0:.1f} s; {int(present.sum())} with targets")
    return raw, calib, present


def world_summary(world: int, reports: list, backend: str, frames: int,
                  wall: str, where: str) -> dict:
    """Check one world's reports of entry.py::dryrun_multichip (its
    backend, K1a's launches per rank and path, and under NCCL one card a
    rank: rank r on cuda:r, every UUID its own), print its line, and return
    its summary."""
    ran = [p for p in reports[0] if isinstance(reports[0][p], dict)]
    check(all(r["backend"] == backend and r["world"] == world for r in reports),
          f"[parallel] world {world} ran under {backend}")
    cards = [r["card"] for r in reports]
    uuids = [r["uuid"] for r in reports]
    if backend == "nccl":
        check(cards == list(range(world)) and len(set(uuids)) == world,
              f"[parallel] world {world}: rank r on cuda:r, UUIDs distinct "
              f"(cards {cards}, UUIDs {uuids})")
    row = {}
    for p in ran:
        per_rank = [r[p]["k1a"] for r in reports]
        want = K1A_PER_PATH[p]
        check(per_rank == [want] * world,
              f"[parallel] world {world} {p}: K1a launched {per_rank} per rank, "
              f"expected {want}")
        row[p] = {"slowest_rank_s": max(r[p]["seconds"] for r in reports),
                  "k1a_per_rank": per_rank,
                  "check_s": max(r[p]["check_s"] for r in reports)}
        if "second_s" in reports[0][p]:
            row[p]["second_slowest_rank_s"] = max(r[p]["second_s"] for r in reports)
    if "sp" in ran:
        for key in ("intensity_max_abs_err_db", "gather_s"):
            row["sp"][key] = max(r["sp"][key] for r in reports)
    checks = max(r["checks_s"] for r in reports)
    refs = max(r["references_s"] for r in reports)
    print(f"[parallel] world {world} ({backend}, {frames} frames, {where}; cards "
          f"{cards}): all checks passed ({checks:.2f} s in the slowest rank's "
          f"checks, of them {refs:.2f} s the single-device chains; {wall}); "
          + "; ".join(f"{p} {v['slowest_rank_s']:.4f} s"
                      + (f", again {v['second_slowest_rank_s']:.4f} s"
                         if "second_slowest_rank_s" in v else "")
                      + f" (slowest rank; its reference and comparison "
                      f"{v['check_s']:.2f} s), K1a {v['k1a_per_rank']}"
                      for p, v in row.items())
          + (f"; sp intensity within {row['sp']['intensity_max_abs_err_db']:.2e} "
             "dB of RadarPipeline above -120 dB, its gather alone "
             f"{row['sp']['gather_s']:.4f} s (slowest rank)" if "sp" in row else ""))
    return {"backend": backend, "frames": frames, "cards": cards, "uuids": uuids,
            "checks_s": checks, "references_s": refs, "paths": row}


def parallel_phase(dev, raw: np.ndarray, calib: np.ndarray, tmp: str) -> dict:
    """[parallel] The parallel paths of parallel/ (entry.py::
    dryrun_multichip, each checked on every rank against the single-device
    chain with the JAX dryrun's tolerances). One card, so: world 1 under
    NCCL on it at the main path's 65,536 frames (the dp chain, bit-equal
    to make_frame_chain; the sp recording against RadarPipeline; a
    Trainer step), then worlds 2 and 4 under gloo, every rank on the same
    card, at PAR_FRAMES frames (every path: dp, tp, pp, the sharded STFT,
    the sp recording, the multihost feed, streaming over the mesh, a
    Trainer step). Prints the slowest rank's wall time per path and K1a's
    launches on each rank. Then the native reader behind
    load_recording_for_chain, and a ``process --trace-dir`` run whose
    trace must name K1a's kernel; then the same command in this process,
    which must launch K1a (its trace is printed, not checked). With more
    cards, ``--parallel-cards`` runs every path under NCCL, one card a
    rank (:func:`parallel_cards_phase`)."""
    from fmcw_radar_processing_tpu_torch.entry import K1A, dryrun_multichip
    from fmcw_radar_processing_tpu_torch.io.native_loader import native_available
    from fmcw_radar_processing_tpu_torch.io.raw_format import (
        load_recording_for_chain,
        read_recording,
    )

    print(f"[parallel] card: {card_line()}")
    # World 1 in this process; worlds 2 and 4 from one spawn of four ranks
    # (each rank pays its start-up once, then joins the worlds it is in),
    # every rank on ``dev`` (an explicit index: gloo's ranks share it).
    t0 = time.perf_counter()
    runs = {1: dryrun_multichip(1, "nccl", dev, recording=(raw, calib),
                                paths=("train", "dp", "sp"))}
    wall1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    runs.update(dryrun_multichip((2, 4), "gloo", dev,
                                 recording=(raw[:PAR_FRAMES], calib),
                                 stream_window=STREAM_WINDOW))
    wall24 = time.perf_counter() - t0
    where = f"every rank on {torch.cuda.get_device_name(dev)}"
    out = {"world1": world_summary(1, runs[1], "nccl", raw.shape[0],
                                   f"{wall1:.2f} s in all", where)}
    for world in (2, 4):
        out[f"world{world}"] = world_summary(
            world, runs[world], "gloo", PAR_FRAMES,
            f"worlds 2 and 4 {wall24:.2f} s in all, one spawn", where)

    # The native streaming reader behind load_recording_for_chain.
    from fmcw_radar_processing_tpu_torch import (
        RadarConfig,
        SyntheticTarget,
        default_device_config,
        synthesize_recording,
        write_recording,
    )

    cfg = RadarConfig.create(default_device_config())
    base = os.path.join(tmp, "native")
    write_recording(base, synthesize_recording(
        cfg, 256, (SyntheticTarget(range_m=7.5, doppler_bin_offset=3),), seed=SEED))
    native = native_available()
    check(native, "[parallel] the native reader builds (g++) on this machine")
    t0 = time.perf_counter()
    n_raw, n_cal, _ = load_recording_for_chain(base)
    native_s = time.perf_counter() - t0
    rec = read_recording(base)
    from fmcw_radar_processing_tpu_torch.utils.cplx import to_pair

    check(n_raw.tobytes() == to_pair(rec.rx1()).tobytes()
          and np.allclose(n_cal, to_pair(rec.calib_vector(0, cfg.nts)), rtol=1e-6),
          "[parallel] native reader = the NumPy reader")
    print(f"[parallel] load_recording_for_chain used the native reader: {native} "
          f"(256 frames in {native_s * 1e3:.2f} ms, byte-equal to the NumPy reader)")

    # process --trace-dir on the card, in a process of its own: the trace
    # names K1a's kernel.
    trace_dir = os.path.join(tmp, "trace")
    proc = subprocess.run(
        [sys.executable, "-m", "fmcw_radar_processing_tpu_torch.serve.cli", "process",
         base, "--output-dir", os.path.join(tmp, "out"), "--trace-dir", trace_dir,
         "--compact-json"], capture_output=True, text=True,
        cwd=ROOT)
    check(proc.returncode == 0, "[parallel] process --trace-dir: "
          + proc.stderr[-2000:])
    files = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
    # K1a is profile_wgmma_kernel<3, false>, demangled or not.
    k1a = [k for k in kernels if re.search(
        r"profile_wgmma_kernel(ILi3ELb0E|<3, false>)", k)]
    check(len(files) == 1 and bool(k1a),
          f"[parallel] the trace names K1a's kernel (kernels: {kernels[:8]})")
    print(f"[parallel] process --trace-dir wrote {files[0]} ({len(events)} events, "
          f"{len(kernels)} kernels) naming K1a: {k1a[0][:60]}")
    out["native_reader"] = native
    out["trace_k1a"] = k1a[0]

    # The same command inside this process, after the phases above, with
    # the launch counters reset just before it: K1a must have run (the
    # CLI's route on the card), whatever this process's trace shows.
    from fmcw_radar_processing_tpu_torch.ops import _lib
    from fmcw_radar_processing_tpu_torch.serve import cli

    trace_dir = os.path.join(tmp, "trace_here")
    _lib.reset_launches()
    rc = cli.main(["process", base, "--output-dir", os.path.join(tmp, "out_here"),
                   "--trace-dir", trace_dir, "--compact-json"])
    torch.cuda.synchronize(dev)
    launched = _lib.LAUNCHES[K1A]
    check(rc == 0 and launched >= 1,
          f"[parallel] process in this process: rc {rc}, K1a launched {launched}")
    with open(os.path.join(trace_dir, os.listdir(trace_dir)[0])) as fh:
        here = sorted({e["name"] for e in json.load(fh)["traceEvents"]
                       if e.get("cat") == "kernel"})
    named = any(re.search(r"profile_wgmma_kernel(ILi3ELb0E|<3, false>)", k)
                for k in here)
    print(f"[parallel] process --trace-dir in this process: K1a launched "
          f"{launched}; its trace names K1a: {named} ({len(here)} kernels: "
          f"{[k[:40] for k in here[:8]]})")
    out["in_process"] = {"k1a_launches": launched, "trace_names_k1a": named}
    return out


def initialize_run(n: int, tmp: str) -> dict:
    """The true multi-process run: n OS processes of
    tests/_torch_multihost_worker.py, each through multihost.initialize
    ("file://" rendezvous, NCCL) on a card of its own, running the sharded
    chain on its quarter of a 32-frame recording (seed 5). Every process's
    gathered outputs must be the same, its card cuda:<pid> with a UUID of
    its own, K1a launched once in each, host 0's artifact seen by all;
    and the outputs must be make_frame_chain's on one card (the waterfall
    bit-equal, the rest within entry.check_vs_single's bounds)."""
    from fmcw_radar_processing_tpu_torch.config import (
        RadarConfig,
        default_device_config,
    )
    from fmcw_radar_processing_tpu_torch.entry import example_recording
    from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import make_frame_chain

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, MULTIHOST_WORKER, f"file://{tmp}/rendezvous", str(n),
         str(pid), tmp, "nccl", "cuda"], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for pid, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0 and f"worker {pid} ok" in log,
              f"[parallel-cards] initialize worker {pid} (rc {p.returncode}):\n"
              + log[-3000:])
    got = [dict(np.load(os.path.join(tmp, f"proc{pid}.npz"))) for pid in range(n)]
    keys = ("waterfall", "range", "speed", "detected")
    check(all(np.array_equal(g[k], got[0][k], equal_nan=k in ("range", "speed"))
              for g in got for k in keys),
          "[parallel-cards] initialize: every process gathered the same outputs")
    cards = [int(g["card"]) for g in got]
    uuids = [str(g["uuid"]) for g in got]
    k1a = [int(g["k1a"]) for g in got]
    check(cards == list(range(n)) and len(set(uuids)) == n and k1a == [1] * n,
          f"[parallel-cards] initialize: cards {cards}, UUIDs {uuids}, K1a {k1a}")
    with open(os.path.join(tmp, "host0_artifact")) as fh:
        check(fh.read() == "ok", "[parallel-cards] initialize: host 0's artifact")
    cfg = RadarConfig.create(default_device_config())
    raw, calib = example_recording(cfg, got[0]["waterfall"].shape[0], seed=5)
    dev = torch.device("cuda", 0)
    want = make_frame_chain(cfg, dev)(torch.as_tensor(raw, device=dev),
                                      torch.as_tensor(calib, device=dev))
    g = got[0]
    check(np.array_equal(g["waterfall"], want.waterfall.cpu().numpy())
          and np.array_equal(g["detected"], want.detected.cpu().numpy()),
          "[parallel-cards] initialize: waterfall and detections = make_frame_chain")
    np.testing.assert_allclose(np.nan_to_num(g["range"]),
                               np.nan_to_num(want.range.cpu().numpy()), rtol=1e-5)
    np.testing.assert_allclose(np.nan_to_num(g["speed"]),
                               np.nan_to_num(want.speed.cpu().numpy()),
                               rtol=1e-4, atol=1e-6)
    print(f"[parallel-cards] multihost.initialize: {n} processes (NCCL, file:// "
          f"rendezvous) on cards {cards}, UUIDs distinct, K1a {k1a}; outputs the "
          f"same in every process and make_frame_chain's; host 0's artifact seen "
          f"by all; {wall:.2f} s from launch to exit")
    return {"processes": n, "cards": cards, "uuids": uuids, "k1a": k1a,
            "wall_s": wall}


def parallel_cards_phase(n: int) -> dict:
    """``--parallel-cards N``: only the parallel paths, under NCCL, one
    card a rank. The kernels are built first; then every path of
    entry.py::PATHS runs through dryrun_multichip at worlds 1, 2 and N on
    the main path's FRAMES-frame recording, uncut, each held on every rank
    to the single-device chain (world_summary: rank r on cuda:r, distinct
    UUIDs, K1a per rank); then worlds 2 and N under gloo and under NCCL
    at PAR_FRAMES frames on the same cards, one card a rank, which prices
    gloo's host staging; then :func:`initialize_run`. Prints the cards,
    the NCCL version and the link between the cards (``nvidia-smi topo
    -m``) first."""
    from fmcw_radar_processing_tpu_torch.config import (
        AlgorithmConfig,
        RadarConfig,
        default_device_config,
    )
    from fmcw_radar_processing_tpu_torch.entry import dryrun_multichip
    from fmcw_radar_processing_tpu_torch.ops import _lib

    print(card_line())
    print("[parallel-cards] cards: " + "; ".join(subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit,pci.bus_id,uuid",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()))
    print(f"[parallel-cards] torch {torch.__version__} cuda {torch.version.cuda} "
          f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}")
    # The link between the cards: nvidia-smi's matrix and NVLink state
    # where the machine lets it read them, peer access as CUDA reports it,
    # and a 1 GiB copy from cuda:0 to each other card.
    topo = "\n".join(subprocess.run(cmd, capture_output=True, text=True).stdout.rstrip()
                     for cmd in (["nvidia-smi", "topo", "-m"],
                                 ["nvidia-smi", "nvlink", "--status", "-i", "0"]))
    links = re.findall(r"Link \d+: (.+)", topo)
    for line in topo.splitlines():
        if "Link" not in line:
            print(f"[topo] {line}")
    print(f"[topo] {len(links)} NVLink links on cuda:0: {sorted(set(links))}")
    out = {"nccl": torch.cuda.nccl.version(), "topo": topo,
           "peer_access": [[i == j or torch.cuda.can_device_access_peer(i, j)
                            for j in range(n)] for i in range(n)],
           "copy_gb_s": {}}
    src = torch.empty(2**28, device="cuda:0")  # 1 GiB of float32
    for j in range(1, n):
        dst = torch.empty_like(src, device=f"cuda:{j}")
        dst.copy_(src)  # warm the path
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(0)
        start.record()
        for _ in range(5):
            dst.copy_(src)
        end.record()
        torch.cuda.synchronize(0)
        torch.cuda.synchronize(j)
        out["copy_gb_s"][f"0->{j}"] = 5 * src.nbytes / (start.elapsed_time(end) / 1e3) / 1e9
        del dst
    del src
    torch.cuda.empty_cache()
    print(f"[topo] peer access {out['peer_access']}; 1 GiB copies from cuda:0, "
          "GB/s: " + ", ".join(f"{k} {v:.1f}" for k, v in out["copy_gb_s"].items()))
    t0 = time.perf_counter()
    _lib.load_kernels()
    print(f"[build] kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    cfg = RadarConfig.create(default_device_config(), AlgorithmConfig.production())
    raw, calib, _ = production_recording(cfg, np.random.default_rng(SEED))
    worlds = tuple(sorted({1, 2, n}))
    t0 = time.perf_counter()
    runs = dryrun_multichip(worlds, "nccl", "cuda", recording=(raw, calib),
                            stream_window=STREAM_WINDOW)
    wall = time.perf_counter() - t0
    for world in worlds:
        out[f"world{world}"] = world_summary(
            world, runs[world], "nccl", FRAMES,
            f"worlds {', '.join(map(str, worlds))} {wall:.2f} s in all, one spawn",
            "one card a rank")
    # What gloo's host staging costs: both backends on the same cards, one
    # card a rank, at PAR_FRAMES frames (the size of the one-card gloo runs).
    for backend in ("gloo", "nccl"):
        t0 = time.perf_counter()
        runs = dryrun_multichip((2, n), backend, "cuda",
                                recording=(raw[:PAR_FRAMES], calib),
                                stream_window=STREAM_WINDOW)
        wall = time.perf_counter() - t0
        for world in (2, n):
            out[f"{backend}_{PAR_FRAMES}_world{world}"] = world_summary(
                world, runs[world], backend, PAR_FRAMES,
                f"worlds 2, {n} {wall:.2f} s in all, one spawn", "one card a rank")
    del raw
    tmp = tempfile.mkdtemp(prefix="chip_smoke_initialize_")
    try:
        out["initialize"] = initialize_run(n, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


@contextlib.contextmanager
def mxu_predicate(fn):
    """Replace utils/cplx.py::takes_mxu_passes, the one predicate that
    decides whether a product takes the TPU's pass semantics, for the
    block: ``lambda t: True`` gives the card's semantics on CPU tensors,
    ``lambda t: False`` bypasses the precision plumbing (every product the
    exact float32 ``torch.matmul``)."""
    from fmcw_radar_processing_tpu_torch.utils import cplx

    real = cplx.takes_mxu_passes
    cplx.takes_mxu_passes = fn
    try:
        yield
    finally:
        cplx.takes_mxu_passes = real


def precision_phase(dev, raw: np.ndarray, calib: np.ndarray,
                    present: np.ndarray, lib) -> dict:
    """[precision] AlgorithmConfig.matmul_precision and rescale_precision on
    the card ("default" one bf16 pass, "high" three, "highest" exact
    float32; utils/cplx.py::precision_matmul).

    1. The SNR ladder (tools/snr_ladder.py, the shape of the TPU's
       SNR_LADDER.json: 256 frames, nfft 256, seed 0) at each precision,
       one JSON line each: stages 1-3 rise strictly with the pass count;
       at "highest" they are at least 130 dB and the intensity's display
       band within 0.001 dB; at "high" that band within 0.005 dB; at
       "default" stage 1 within 60-72 dB (the TPU's record 66.1).
    2. RadarPipeline on the main path's recording under
       AlgorithmConfig.production(stft_impl="xla", matmul_precision=p,
       rescale_precision=p) for each p, counted: K1a once a recording and
       no other kernel; detections, ranges and speeds identical across p
       (those of "highest" equal to the injected frames); against
       "highest": the waterfall's and the packed slow-time signal's SNR,
       the intensity's display-band max error; wall time, peak memory.
    3. AlgorithmConfig.production() (the kernel export, matmul_precision
       "highest") bit-equal to the same call with the precision plumbing
       bypassed (:func:`mxu_predicate` False), and the predicate never
       asked in the first: every product took the exact branch.
    """
    from fmcw_radar_processing_tpu_torch import (
        AlgorithmConfig,
        RadarConfig,
        default_device_config,
    )
    from fmcw_radar_processing_tpu_torch.entry import K1A
    from fmcw_radar_processing_tpu_torch.pipeline.frame_chain import pack_slow_time
    from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline
    from fmcw_radar_processing_tpu_torch.tools.snr_ladder import (
        PRECISIONS,
        build_ladder,
    )
    from fmcw_radar_processing_tpu_torch.utils import cplx

    t_phase = time.perf_counter()
    out: dict = {"ladder": {}, "recording": {}}
    stages = ("1_slow_time_snr_db", "2_magnitude_snr_db", "3_psd_linear_snr_db")

    def display(lad):
        return lad["intensity_bands"]["display_band_ge_-40dB"]["max_abs_err_db"]

    for p in PRECISIONS:
        t0 = time.perf_counter()
        lad = build_ladder(frames=256, nfft=256, seed=0, precision=p, device=dev)
        out["ladder"][p] = lad
        print(f"[precision] ladder {p} ({time.perf_counter() - t0:.2f} s): "
              f"{json.dumps(lad)}")
    lads = out["ladder"]
    for st in stages:
        d, h, x = (lads[p][st] for p in PRECISIONS)
        check(d < h < x, f"[precision] ladder {st} rises with the pass count "
              f"({d} < {h} < {x})")
    check(all(lads["highest"][st] >= 130.0 for st in stages),
          f"[precision] ladder 'highest' stages 1-3 >= 130 dB "
          f"({[lads['highest'][st] for st in stages]})")
    check(display(lads["highest"]) <= 0.001,
          f"[precision] ladder 'highest' display band {display(lads['highest'])} "
          "dB (tol 0.001)")
    check(display(lads["high"]) <= 0.005,
          f"[precision] ladder 'high' display band {display(lads['high'])} dB "
          "(tol 0.005)")
    check(60.0 <= lads["default"]["1_slow_time_snr_db"] <= 72.0,
          f"[precision] ladder 'default' stage 1 "
          f"{lads['default']['1_slow_time_snr_db']} dB (60-72)")
    print("[precision] ladder: stages 1-3 dB by precision "
          + ", ".join(f"{p} {[lads[p][st] for st in stages]} display band "
                      f"{display(lads[p])} dB" for p in PRECISIONS))

    # 2. The full-width recording through the normal entry point, "highest"
    # first as the others' reference.
    ref = None
    for p in ("highest", "high", "default"):
        cfg = RadarConfig.create(default_device_config(), AlgorithmConfig.production(
            stft_impl="xla", matmul_precision=p, rescale_precision=p))
        pipe = RadarPipeline(cfg, device=dev)
        pipe.process_recording(raw[:256], calib)  # warm
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        lib.reset_launches()
        t0 = time.perf_counter()
        rec = pipe.process_recording(raw, calib)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        launches = dict(lib.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        check(launches == {k: int(k == K1A) for k in launches},
              f"[precision] {p}: K1a once and no other kernel ({launches})")
        chain_out = pipe.run_chain(raw, calib)
        sig, count = pack_slow_time(chain_out.strongest_chirps,
                                    chain_out.detected, cfg.pn)
        slow = sig[: int(count)].cpu().numpy().astype(np.float64)
        del chain_out, sig, pipe
        meas = (rec.detected, rec.target_range, rec.target_speed)
        row = {"seconds": seconds, "frames_per_s": FRAMES / seconds,
               "peak_gib": peak, "k1a_launches": launches[K1A]}
        if ref is None:
            check(np.array_equal(rec.detected, present),
                  "[precision] highest: detected frames = target frames")
            ref = {"meas": meas, "waterfall": rec.waterfall, "slow": slow,
                   "intensity": rec.spectrogram_intensity}
            band = (ref["intensity"] >= -40.0) & (ref["intensity"] <= 0.0)
        else:
            same = [np.array_equal(a, b, equal_nan=True)
                    for a, b in zip(meas, ref["meas"])]
            if not all(same):
                print(f"[precision] {p}: detections, ranges, speeds equal to "
                      f"'highest': {same}; detected {int(rec.detected.sum())} "
                      f"vs {int(ref['meas'][0].sum())}")
            check(all(same), f"[precision] {p}: detections, ranges and speeds "
                  "identical to 'highest'")
            for key, got, want in (("waterfall", rec.waterfall, ref["waterfall"]),
                                   ("slow_time", slow, ref["slow"])):
                row[f"{key}_snr_db_vs_highest"] = (
                    float("inf") if np.array_equal(got, want) else snr_db(got, want))
            row["intensity_display_band_max_err_db_vs_highest"] = float(
                np.abs(rec.spectrogram_intensity - ref["intensity"])[band].max())
        out["recording"][p] = row
        print(f"[precision] {p}: process_recording stft_impl='xla' {FRAMES} "
              f"frames {seconds:.4f} s ({FRAMES / seconds:,.0f} frames/s), peak "
              f"device memory {peak:.2f} GiB, launches {launches}; "
              + ", ".join(f"{k} {v:.6g}" for k, v in row.items()
                          if k.endswith("highest")))
        del rec
        torch.cuda.empty_cache()
    del ref

    # 3. The default path with and without the precision plumbing.
    pcfg = RadarConfig.create(default_device_config(), AlgorithmConfig.production())
    check(pcfg.algorithm.matmul_precision == "highest",
          "[precision] production() keeps matmul_precision 'highest'")
    ppipe = RadarPipeline(pcfg, device=dev)
    asked = []
    real = cplx.takes_mxu_passes
    with mxu_predicate(lambda t: asked.append(t.device) or real(t)):
        a = ppipe.process_recording(raw, calib)
    with mxu_predicate(lambda t: False):
        b = ppipe.process_recording(raw, calib)
    fields = ("waterfall", "detected", "target_range", "target_speed",
              "spectrogram_intensity", "spectrogram_psd_db")
    equal = {f: np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True)
             for f in fields}
    check(all(equal.values()), f"[precision] production() bit-equal with the "
          f"plumbing bypassed: {equal}")
    check(not asked, f"[precision] production(): the pass predicate asked "
          f"{len(asked)} times (every product must take the exact branch)")
    print(f"[precision] production() (kernel export, matmul_precision 'highest') "
          f"bit-equal to the same call with the precision plumbing bypassed in "
          f"{', '.join(fields)}; the pass predicate was asked 0 times")
    del a, b, ppipe
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[precision] phase {out['seconds']:.1f} s")
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on one card.")
    ap.add_argument("--parent", metavar="DIR",
                    help="another checkout of the repo whose K1c and K7 are timed "
                         "against this one's, in turns, on the same inputs")
    ap.add_argument("--parallel-cards", metavar="N", type=int,
                    help="run only the parallel paths, under NCCL with one card "
                         "a rank, on N cards (worlds 1, 2 and N at the main "
                         "path's size), and N processes through "
                         "multihost.initialize")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a CUDA "
              "card", file=sys.stderr)
        return 2
    if args.parallel_cards is not None:
        n, have = args.parallel_cards, torch.cuda.device_count()
        if n < 2 or FRAMES % (2 * n):
            ap.error(f"--parallel-cards takes an N ≥ 2 dividing {FRAMES // 2}")
        if have < n:
            print(f"chip_smoke: --parallel-cards {n} needs {n} cards, found "
                  f"{have}", file=sys.stderr)
            return 2
        print(json.dumps({"parallel_cards": parallel_cards_phase(n)}, default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    from fmcw_radar_processing_tpu_torch import (
        AlgorithmConfig,
        LocalStorage,
        RadarConfig,
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
        # K1a, K1b and K6 are profile_wgmma_kernel<3, false>, <6, false> and
        # <6, true> (mangled ILi3ELb0EE, ...), K1c profile_bf16_tma_kernel<
        # slices>, K7 search_peaks_kernel<values a lane> at K = 32·values:
        # "Function properties for" the name, its stack and spill line, then
        # "Used".
        def props(pattern):
            return re.findall(
                r"Function properties for \S*" + pattern + r"\S*\n[^\n]*?(\d+) "
                r"bytes spill stores[^\n]*\n[^\n]*Used (\d+) registers([^\n]*)",
                text)

        names = {("3", "0"): "K1a", ("6", "0"): "K1b", ("6", "1"): "K6"}
        wg = {names.get((p, rf), p + rf): f"{n} registers, {sp} bytes spilled"
              for p, rf, sp, n, _ in props(r"profile_wgmma_kernelILi(\d)ELb(\d)E")}
        k1c = {f"{64 * int(q)}-bin groups": f"{n} registers, {sp} bytes spilled"
               for q, sp, n, _ in props(r"profile_bf16_tma_kernelILi(\d)E")}
        # ptxas's notes where it had to serialize wgmma (C7514) or add waits.
        serial = sorted({a + b for a, b in re.findall(
            r"\(C75\d\d\)[^\n]*(profile_bf16_tma_kernel|profile_wgmma_kernel)"
            r"(ILi\d+E(?:Lb\dE)?)?", text)})
        k7 = {f"K {32 * int(v)}": f"{n} registers, {sp} bytes spilled"
              for v, sp, n, _ in props(r"search_peaks_kernelILi(\d+)E")}
        print(f"[build] ptxas: {len(regs)} kernels, at most {max(regs)} registers "
              f"a thread, {sum(spills)} bytes of spill stores in all; the "
              f"wgmma fast-time kernels: {wg}; K1c (the producer warpgroup gives "
              f"its consumers 160 registers a thread by setmaxnreg): {k1c}; K7: "
              f"{k7}; wgmma serialized or waits added by ptxas in: "
              f"{serial or 'none'}")
    regs_1c, static_1c, dynamic_1c = (ctypes.c_int(), ctypes.c_int(), ctypes.c_int())
    check(_lib.load_kernels().fast_time_profile_bf16_attributes(
        ctypes.byref(regs_1c), ctypes.byref(static_1c), ctypes.byref(dynamic_1c)) == 0,
        "K1c's attributes")
    print(f"[build] K1c profile_bf16_tma_kernel: {regs_1c.value} registers a "
          f"thread at launch, shared memory {static_1c.value} bytes static + "
          f"{dynamic_1c.value} dynamic (cudaFuncGetAttributes)")
    parent = load_parent(args.parent) if args.parent else None
    parent_readings: dict[str, dict] = {}

    # The main path's input: a 65,536-frame recording, two targets, about
    # 10% of frames muted so that slow-time packing is not the identity.
    cfg = RadarConfig.create(default_device_config(), AlgorithmConfig.production())
    rng = np.random.default_rng(SEED)  # drawn on below, after the mask
    raw, calib, present = production_recording(cfg, rng)
    strong, weak = main_targets()

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
    ms1a, plain_ms1a, second1a, b2b1a = time_pair(
        lambda: ftc.fast_time_profile_b3(x, w_hi, w_lo, off, cfg.pn),
        lambda: ftc.fast_time_profile_b3_ref(x, w_hi, w_lo, off, cfg.pn))
    xb = x.to(torch.bfloat16)
    yard_ms = time_turns({"mm": lambda: torch.matmul(xb, w_hi)})["mm"]
    del xb
    print(f"[time] K1a kernel {ms1a:.4f} ms (second in its turn {second1a:.4f}, "
          f"back to back {b2b1a:.4f}), "
          f"plain {plain_ms1a:.4f} ms (median of {REPS}); yardstick, not used "
          f"by the port: one bf16 "
          f"torch.matmul [{rows_x},128]@[128,512] alone {yard_ms:.4f} ms")
    rows.append(dict(name="fast_time_profile_b3", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/fast_time_wgmma.cu",
                     replaces="fmcw_radar_processing_tpu/ops/fast_time_pallas.py:151",
                     max_abs_err=k1a_err, ms=ms1a, plain_ms=plain_ms1a,
                     ms_second=second1a, ms_b2b=b2b1a,
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
    ms1c, plain_ms1c, second1c, b2b1c = time_pair(
        lambda: ftc.fast_time_profile_bf16(x, w_hi, off, cfg.pn),
        lambda: ftc.fast_time_profile_bf16_ref(x, w_hi, off, cfg.pn))
    print(f"[time] K1c kernel {ms1c:.4f} ms (second in its turn {second1c:.4f}, "
          f"back to back {b2b1c:.4f}), plain {plain_ms1c:.4f} ms (median of "
          f"{REPS}); the same yardstick, not used by the port: one bf16 "
          f"torch.matmul [{rows_x},128]@[128,512] alone {yard_ms:.4f} ms")
    # K1c at K 320, the same x: the 256-bin group in one launch, then the
    # 64-bin rest in a second, each over every SM; x is read twice.
    cfg320 = RadarConfig.create(default_device_config(),
                                AlgorithmConfig.production(range_fft_size=320))
    w320 = ftc.blocked_weight(cfg320, dev)
    off320 = ftc.calib_offset(torch.as_tensor(calib, device=dev), w320)
    w320 = ftc.split_bf16x3(w320)[0]
    ref320 = ftc.fast_time_profile_bf16_ref(x, w320, off320, cfg.pn)
    err = (ftc.fast_time_profile_bf16(x, w320, off320, cfg.pn) - ref320).abs()
    ok320 = bool((err <= 1e-2 + 1e-5 * ref320.abs()).all())
    b2b320 = time_back_to_back(lambda: ftc.fast_time_profile_bf16(x, w320, off320, cfg.pn))
    bound320 = bound(x.numel() * 4 + w320.numel() * 2 + off320.numel() * 4
                     + ref320.numel() * 4, product_ops * 320 / 256, "bf16")
    print(f"[time] K1c at K 320, launches (bin0, group_bins, groups, blocks) "
          f"{ftc.k1c_geometry(rows_x, 320, _lib.sm_count(dev))}: max_abs_err "
          f"{float(err.max()):.6g} vs its plain version (tol 1e-2 + 1e-5·|ref|) "
          f"{'ok' if ok320 else 'FAIL'}; back to back {b2b320:.4f} ms "
          f"({b2b320 / b2b1c:.3f}x K 256's), bound {bound320[0]:.4f} ms "
          f"({bound320[1]}, x read once)")
    check(ok320, "K1c parity at K 320")
    del err, ref320, w320, off320
    if parent is not None:
        parent_readings["fast_time_profile_bf16"] = parent_turns(
            "K1c", lambda x_: parent[0].fast_time_profile_bf16(x_, w_hi, off, cfg.pn),
            lambda x_: ftc.fast_time_profile_bf16(x_, w_hi, off, cfg.pn), (x,),
            lambda a, b: bool(((a - b).abs() <= 2e-2 + 2e-5 * b.abs()).all()))
    rows.append(dict(name="fast_time_profile_bf16", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/fast_time_wgmma.cu",
                     replaces="fmcw_radar_processing_tpu/ops/fast_time_pallas.py:130",
                     max_abs_err=k1c_err, ms=ms1c, plain_ms=plain_ms1c,
                     ms_second=second1c, ms_b2b=b2b1c,
                     bound=bound(x.numel() * 4 + w_hi.numel() * 2
                                 + off.numel() * 4 + prof_bytes,
                                 product_ops, "bf16")))

    # K1b, the HIGHEST class (impl "pallas_profile"): six bf16 passes on the
    # tensor cores, held to its six-pass plain version and to the exact
    # float32 plain profile (120 dB).
    prof_exact = prof
    prof_b = ftc.fast_time_profile(x, w, off, cfg.pn)
    prof_b6 = ftc.fast_time_profile_b6_ref(x, w, off, cfg.pn)
    err = (prof_b - prof_b6).abs()
    k1_err = float(err.max())
    k1b_snr = snr_db(prof_b, prof_exact)
    k1_ok = bool((err <= 1e-2 + 1e-5 * prof_b6.abs()).all()) and k1b_snr >= 120.0
    print(f"[parity] K1b fast_time_profile {tuple(x.shape)} -> {tuple(prof_b.shape)}: "
          f"max_abs_err {k1_err:.6g} vs its six-pass plain version (tol 1e-2 + "
          f"1e-5·|ref|); {k1b_snr:.2f} dB SNR vs the exact plain profile (tol "
          f"120 dB) {'ok' if k1_ok else 'FAIL'}")
    check(k1_ok, "K1b parity")
    del err, prof_b6
    ms, plain_ms, second1b, b2b1b = time_pair(
        lambda: ftc.fast_time_profile(x, w, off, cfg.pn),
        lambda: ftc.fast_time_profile_b6_ref(x, w, off, cfg.pn))
    # The bound of the TPU kernel's arithmetic, six bf16 passes, and beside
    # it the float32 CUDA-core bound of one exact product.
    b6_bound = bound(x.numel() * 4 + w.numel() * 4 + off.numel() * 4 + prof_bytes,
                     6 * product_ops, "bf16")
    f32_bound = bound(x.numel() * 4 + w.numel() * 4 + off.numel() * 4 + prof_bytes,
                      product_ops, "f32")
    print(f"[time] K1b kernel {ms:.4f} ms (second in its turn {second1b:.4f}), "
          f"plain {plain_ms:.4f} ms (median of {REPS}); bound {b6_bound[0]:.4f} ms "
          f"({b6_bound[1]}: 6 × {product_ops / 1e9:.1f} GFLOP at 989 TFLOP/s "
          f"bf16; the float32 CUDA-core bound of one exact product is "
          f"{f32_bound[0]:.4f} ms)")
    rows.append(dict(name="fast_time_profile", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/fast_time_wgmma.cu",
                     replaces="fmcw_radar_processing_tpu/ops/fast_time_pallas.py:130",
                     max_abs_err=k1_err, ms=ms, plain_ms=plain_ms,
                     ms_second=second1b, ms_b2b=b2b1b,
                     snr_db_vs_exact=k1b_snr, bound=b6_bound))

    # K6 on the same x: the range FFT [F, PN, K, 2] (2 GiB) and the profile,
    # held to its six-pass plain version, the cube to the exact float32
    # product (rtol 1e-5 / atol 1e-5·max|rf|, the JAX package's bound
    # between two summation orders), the profile bit-equal to K1b's.
    rf, prof6 = ftc.fast_time(x, w, off, cfg.pn)
    rf_ref, prof6_ref = ftc.fast_time_b6_ref(x, w, off, cfg.pn)
    err = (rf - rf_ref).abs()
    k6_err = float(err.max())
    k6_ok = bool((err <= 1e-2 + 1e-5 * rf_ref.abs()).all())
    k6_ok &= bool(((prof6 - prof6_ref).abs() <= 1e-2 + 1e-5 * prof6_ref.abs()).all())
    del err, rf_ref, prof6_ref
    rf_x = ftc.fast_time_ref(x, w, off, cfg.pn)[0]
    rf_scale = float(rf_x.abs().max())
    rf_x_err = float((rf - rf_x).abs().max())
    k6_ok &= bool(((rf - rf_x).abs() <= 1e-5 * rf_scale + 1e-5 * rf_x.abs()).all())
    rf_snr = snr_db(rf, rf_x)
    del rf_x
    same = bool(torch.equal(prof6, prof_b))
    k6_snr = snr_db(prof6, prof_exact)
    k6_ok &= same and k6_snr >= 120.0
    print(f"[parity] K6 fast_time {tuple(x.shape)} -> rf {tuple(rf.shape)}: "
          f"rf max_abs_err {k6_err:.6g} vs its six-pass plain version (tol 1e-2 + "
          f"1e-5·|ref|); rf {rf_x_err:.6g} from the exact float32 product (tol "
          f"1e-5·max|rf| = {1e-5 * rf_scale:.4g} + 1e-5·|ref|; {rf_snr:.2f} dB "
          f"SNR); profile bit-equal to K1b's: {same}, {k6_snr:.2f} dB SNR vs the "
          f"exact plain profile (tol 120 dB) {'ok' if k6_ok else 'FAIL'}")
    check(k6_ok, "K6 parity")
    del rf, prof_b
    prof_exact_host = prof_exact.cpu()
    del prof_exact, prof
    torch.cuda.empty_cache()
    ms6, plain_ms6, second6, b2b6 = time_pair(lambda: ftc.fast_time(x, w, off, cfg.pn),
                                        lambda: ftc.fast_time_b6_ref(x, w, off, cfg.pn))
    rf_bytes = rows_x * k_bins * 2 * 4
    b6_bound6 = bound(x.numel() * 4 + w.numel() * 4 + off.numel() * 4 + prof_bytes
                      + rf_bytes, 6 * product_ops, "bf16")
    print(f"[time] K6 kernel {ms6:.4f} ms (second in its turn {second6:.4f}), plain "
          f"{plain_ms6:.4f} ms (median of {REPS}); bound {b6_bound6[0]:.4f} ms "
          f"({b6_bound6[1]}; its bytes, the {rf_bytes / 1e6:,.0f} MB cube with x and "
          f"the profile, "
          f"{(x.numel() * 4 + prof_bytes + rf_bytes) / HBM_BYTES_S * 1e3:.4f} ms)")
    rows.append(dict(name="fast_time", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/fast_time_wgmma.cu",
                     replaces="fmcw_radar_processing_tpu/ops/fast_time_pallas.py:35",
                     max_abs_err=k6_err, ms=ms6, plain_ms=plain_ms6,
                     ms_second=second6, ms_b2b=b2b6,
                     snr_db_vs_exact=k6_snr, bound=b6_bound6))
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
    del got, want
    k7_widths_check(dtc, dev)
    ms7, plain_ms7, second7, _ = time_pair(lambda: dtc.search_peaks_fused(prof6, cfg),
                                           lambda: dtc.search_peaks_fused_ref(prof6, cfg))
    # Back to back on two copies of the profile in turn (2 × 64 MiB, more
    # than the 50 MB L2), so no launch finds its input in L2.
    prof6_copy = prof6.clone()
    b2b7 = time_back_to_back(alternate(lambda p: dtc.search_peaks_fused(p, cfg),
                                       (prof6, prof6_copy)))
    prof7_ms = profiler_kernel_ms(
        alternate(lambda p: dtc.search_peaks_fused(p, cfg), (prof6, prof6_copy)),
        "search_peaks_kernel")
    print(f"[time] K7 kernel {ms7:.4f} ms (second in its turn {second7:.4f}), "
          f"back to back {b2b7:.4f} (two copies in turn), plain {plain_ms7:.4f} "
          f"ms (T=1, median of {REPS}); torch.profiler device time of the "
          f"kernel: {'not measured (no device time)' if prof7_ms is None else prof7_ms}"
          " ms")
    if parent is not None:
        parent_readings["search_peaks_fused"] = parent_turns(
            "K7", lambda p: parent[1].search_peaks_fused(p, cfg),
            lambda p: dtc.search_peaks_fused(p, cfg), (prof6, prof6_copy),
            lambda a, b: all(torch.equal(u, v) for u, v in zip(a, b)))
    del prof6_copy
    rows.append(dict(name="search_peaks_fused", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/detect.cu",
                     replaces="fmcw_radar_processing_tpu/ops/detect_pallas.py:29",
                     max_abs_err=k7_err, ms=ms7, plain_ms=plain_ms7,
                     ms_second=second7, ms_b2b=b2b7, profiler_ms=prof7_ms,
                     bound=bound(prof6.numel() * 4 + prof6.shape[0] * (4 + 4 + 1),
                                 3.0 * prof6.numel(), "f32")))
    del prof6
    torch.cuda.empty_cache()

    # K2a, K2b + K3 on a packed-signal-shaped input: L = F·PN, about 90%
    # valid. The production export is K2a (bf16x3 on the tensor cores) and
    # K3; the exact one K2b (K4a's kernel) and K3.
    op = StftOperator.create(window_length=20, beta=3.0, nfft=256,
                             fs=1.0 / cfg.derived.prt)
    length = FRAMES * cfg.pn
    count = int(present.sum()) * cfg.pn
    sig_np = np.zeros(length, np.float32)
    sig_np[:count] = np.abs(rng.standard_normal(count)
                            + 4.0 * np.sin(np.arange(count) * 0.3)).astype(np.float32)
    sig = torch.as_tensor(sig_np, device=dev)
    nb = op.num_bins
    nv = count - 19
    t_pad = -(-(length - 19) // stc.PSD_TILE) * stc.PSD_TILE
    f32, bf16 = torch.float32, torch.bfloat16
    k2a_err = k2b_err = k3_err = 0.0
    k2a_snr = k2a_band = None
    for db_dtype, int_dtype in ((f32, f32), (bf16, bf16)):
        align = 16 if db_dtype == bf16 else 8
        nb_pad = -(-nb // align) * align
        a2 = torch.as_tensor(stc._folded_operator(op, align), device=dev)
        # K2a against its plain version (the same split, summed in another
        # order), and against the exact plain PSD: SNR, and the intensity
        # of both through K3 (float32 stores) on clim [-40, 0].
        p, tmax = stc.psd_phase1_b3(sig, nv, a2, nb_pad, t_pad)
        p_ref, tmax_ref = stc.psd_phase1_b3_ref(sig, nv, a2, nb_pad, t_pad)
        gmax_ref = float(tmax_ref.max())
        perr = (p - p_ref).abs()
        ok = bool((perr <= 1e-6 * gmax_ref + 1e-4 * p_ref.abs()).all()) and bool(
            ((tmax - tmax_ref).abs() <= 1e-5 * tmax_ref.abs()).all())
        err = float(perr.max())
        k2a_err = max(k2a_err, err)
        del perr, p_ref
        p_x, tmax_x = stc.psd_phase1_ref(sig, nv, a2, nb_pad, t_pad)
        snr = snr_db(p, p_x)
        out_a = stc.db_rescale(p, tmax.amax(), nb, 1024, f32, f32)[1]
        out_x = stc.db_rescale(p_x, tmax_x.amax(), nb, 1024, f32, f32)[1]
        band = (out_x >= -40.0) & (out_x <= 0.0)
        band_err = float((out_a - out_x).abs()[band].max())
        del out_a, out_x, band
        ok &= snr >= 100.0 and band_err <= 1e-3
        k2a_snr = snr if k2a_snr is None else min(k2a_snr, snr)
        k2a_band = band_err if k2a_band is None else max(k2a_band, band_err)
        print(f"[parity] K2a psd_phase1_b3 L={length} nb_pad={nb_pad}: p "
              f"max_abs_err {err:.6g} vs its plain version (tol 1e-6·gmax + "
              f"1e-4·|ref|; gmax {gmax_ref:.6g}); {snr:.2f} dB SNR vs the exact "
              f"plain PSD (tol 100 dB); intensity {band_err:.4g} dB from the "
              f"exact export's on clim [-40, 0] (tol 1e-3) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, "K2a parity")
        # K2b (K4a's kernel) against the exact plain version.
        p_b, tmax_b = stc.psd_phase1(sig, nv, a2, nb_pad, t_pad)
        perr = (p_b - p_x).abs()
        ok = bool((perr <= 1e-10 + 1e-4 * p_x.abs()).all()) and bool(
            ((tmax_b - tmax_x).abs() <= 1e-5 * tmax_x.abs()).all())
        err = float(perr.max())
        k2b_err = max(k2b_err, err)
        print(f"[parity] K2b psd_phase1 L={length} nb_pad={nb_pad}: p max_abs_err "
              f"{err:.6g} (tol 1e-10 + 1e-4·|ref|) {'ok' if ok else 'FAIL'}")
        check(ok, "K2b parity")
        del p_b, tmax_b, perr, p_x
        if db_dtype == bf16:
            # The bf16 PSD store's flag of K2a, K2b and K4a (nfft 1,000,
            # nb_pad 512, on the last 16,384 frames' samples): p and the
            # maxima bit-equal to the bf16 rounding of the kernel's own
            # unrounded run.
            start = length - 16_384 * cfg.pn
            w_op = StftOperator.create(window_length=20, beta=3.0, nfft=1_000,
                                       fs=1.0 / cfg.derived.prt)
            w_a2 = torch.as_tensor(stc._folded_operator(w_op, 16), device=dev)
            w_sig = sig[start:].contiguous()
            w_t_pad = -(-(w_sig.shape[0] - 19) // stc.PSD_TILE) * stc.PSD_TILE
            same = {}
            for name, fn, args in (
                    ("K2a", stc.psd_phase1_b3, (sig, nv, a2, nb_pad, t_pad)),
                    ("K2b", stc.psd_phase1, (sig, nv, a2, nb_pad, t_pad)),
                    ("K4a", stc.psd_phase1_tiled,
                     (w_sig, nv - start, w_a2, 512, w_t_pad))):
                p32 = fn(*args)[0]
                p_r, tmax_r = fn(*args, round_bf16=True)
                pq = p32.to(bf16).float()
                want_max = pq.reshape(pq.shape[0], -1, stc.PSD_TILE).amax(dim=(0, 2))
                same[name] = bool(torch.equal(p_r, pq)) and bool(torch.equal(
                    stc._tile_max(tmax_r, args[4]), want_max))
                del p32, p_r, pq
            print(f"[parity] bf16 PSD store flag: rounded runs bit-equal to the "
                  f"bf16 rounding of the unrounded ones {same} "
                  f"{'ok' if all(same.values()) else 'FAIL'}")
            check(all(same.values()), "bf16 PSD store flag")
            del w_sig, w_a2
        gmax = tmax.amax()
        db, out = stc.db_rescale(p, gmax, nb, 1024, db_dtype, int_dtype)
        db_ref, out_ref = stc.db_rescale_ref(p, gmax, nb, 1024, db_dtype, int_dtype)
        floor_ok = bool(torch.equal(db == DB_FLOOR, db_ref == DB_FLOOR))
        errs = []
        ok = floor_ok
        for got, want in ((db, db_ref), (out, out_ref)):
            d = (got.float() - want.float()).abs()
            errs.append(float(d.max()))
            if db_dtype == f32:
                ok &= bool((d <= 2e-3).all())
            else:
                ok &= bool((d <= bf16_ulp(want.float())).all())
            del d
        tol = "2e-3 dB" if db_dtype == f32 else "one bf16 ulp"
        print(f"[parity] K3 db_rescale stores {str(db_dtype)[6:]}: db max_abs_err "
              f"{errs[0]:.6g}, intensity max_abs_err {errs[1]:.6g} (tol {tol}); "
              f"floor mask equal {floor_ok} {'ok' if ok else 'FAIL'}")
        check(ok, f"K3 parity ({db_dtype})")
        if db_dtype == f32:
            k3_err = max(errs)
        del db, out, db_ref, out_ref
    # Time the production variant (bf16 stores, nb_pad 144): K2a, K2b, K3,
    # each in turns with its plain version; and, as a yardstick the port
    # never calls, one bf16 torch.matmul of the operator [2·nb_pad, 32]
    # (taps zero-padded) and the frames [32, t_pad] (the Hankel matrix of
    # the signal, built beforehand), with its bf16 [2·nb_pad, t_pad] output.
    ms2a, plain_ms2a, second2a, b2b2a = time_pair(
        lambda: stc.psd_phase1_b3(sig, nv, a2, nb_pad, t_pad),
        lambda: stc.psd_phase1_b3_ref(sig, nv, a2, nb_pad, t_pad))
    ms2b, plain_ms2b, second2b, b2b2b = time_pair(
        lambda: stc.psd_phase1(sig, nv, a2, nb_pad, t_pad),
        lambda: stc.psd_phase1_ref(sig, nv, a2, nb_pad, t_pad))
    a_bf = torch.nn.functional.pad(a2, (0, 12)).to(bf16)
    f_bf = (torch.nn.functional.pad(sig, (0, t_pad + 31 - length))
            .unfold(0, 32, 1).T.contiguous().to(bf16))
    yard2 = time_turns({"mm": lambda: torch.matmul(a_bf, f_bf)})["mm"]
    del a_bf, f_bf
    # The card's write rate for the PSD's bytes: a fill of a preallocated
    # [nb_pad, t_pad] float32 map (nothing read).
    fill_buf = torch.empty((nb_pad, t_pad), device=dev)
    fill2 = time_turns({"fill": lambda: fill_buf.fill_(1.0)})["fill"]
    del fill_buf
    ms3, plain_ms3, second3, b2b3 = time_pair(
        lambda: stc.db_rescale(p, gmax, nb, 1024, bf16, bf16),
        lambda: stc.db_rescale_ref(p, gmax, nb, 1024, bf16, bf16))
    print(f"[time] K2a kernel {ms2a:.4f} ms (second in its turn {second2a:.4f}), "
          f"plain {plain_ms2a:.4f} ms; K2b kernel {ms2b:.4f} ms (second in its "
          f"turn {second2b:.4f}), plain {plain_ms2b:.4f} ms; K3 kernel "
          f"{ms3:.4f} ms (second in its turn {second3:.4f}), plain "
          f"{plain_ms3:.4f} ms (nb_pad {nb_pad}, median of {REPS}); yardstick, "
          f"not used by the port: one bf16 torch.matmul [{2 * nb_pad},32]@"
          f"[32,{t_pad}] alone {yard2:.4f} ms; a fill of the [{nb_pad}, "
          f"{t_pad}] float32 map {fill2:.4f} ms")
    psd_bytes = length * 4 + a2.numel() * 4 + nb_pad * t_pad * 4 + t_pad // stc.PSD_TILE * 4
    rows.append(dict(name="psd_phase1_b3", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/stft_psd_b3.cu",
                     replaces="fmcw_radar_processing_tpu/ops/stft_pallas.py:134",
                     max_abs_err=k2a_err, ms=ms2a, plain_ms=plain_ms2a,
                     ms_second=second2a, ms_b2b=b2b2a, snr_db_vs_exact=k2a_snr,
                     bound=bound(psd_bytes, b3_ops(nv, nb_pad), "bf16"),
                     yardstick_ms=yard2, fill_ms=fill2,
                     library_note=f"{NO_LIBRARY} (yardstick_ms: one bf16 "
                                  "torch.matmul of the operator and the frames "
                                  "alone; fill_ms: a fill of the PSD's bytes)"))
    rows.append(dict(name="psd_phase1", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/stft_export_tiled.cu",
                     replaces="fmcw_radar_processing_tpu/ops/stft_pallas.py:106",
                     max_abs_err=k2b_err, ms=ms2b, plain_ms=plain_ms2b,
                     ms_second=second2b, ms_b2b=b2b2b,
                     bound=bound(psd_bytes, psd_ops(nv, nb_pad), "f32")))
    rows.append(dict(name="db_rescale", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/stft_export.cu",
                     replaces="fmcw_radar_processing_tpu/ops/stft_pallas.py:282",
                     max_abs_err=k3_err, ms=ms3, plain_ms=plain_ms3,
                     ms_second=second3, ms_b2b=b2b3,
                     bound=bound(nb_pad * t_pad * (4 + 2) + 1024 * t_pad * 2
                                 + 1024 * 12 + 4, db_ops(t_pad, nb_pad), "f32")))
    del p, tmax
    torch.cuda.empty_cache()
    # K3 at nfft 430 and 512 (the production profile's stft_nfft=512
    # option) on the last 16,384 frames' samples, which straddle the valid
    # count.
    start = length - 16_384 * cfg.pn
    check(0 < count - start < length - start, "the nfft 512 input straddles the count")
    for wide_nfft in (430, 512):
        k3_wide_check(stc, DB_FLOOR, sig[start:].contiguous(), count - start - 19,
                      StftOperator.create(window_length=20, beta=3.0, nfft=wide_nfft,
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
            ((ms4a, plain_ms4a, second4a, b2b4a),
             (ms4b, plain_ms4b, second4b, b2b4b)) = k4_times(
                stc, f_op.num_bins, ops_, REPS)
            # The share of a first-in-turn reading that is the allocator's:
            # torch.empty of a dB map alone, in turns with K4b's plain version.
            p_f, g_f = ops_[5], ops_[6]
            al_first, _, al_second, _ = time_pair(
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
    (wms4a, wplain4a, _, _), (wms4b, wplain4b, _, _) = k4_times(stc, w_op.num_bins, ops_,
                                                    WIDE_REPS)
    print(f"[time] K4a kernel {wms4a:.4f} ms, plain {wplain4a:.4f} ms; "
          f"K4b kernel {wms4b:.4f} ms, plain {wplain4b:.4f} ms "
          f"(nfft {w_op.nfft}, L {w_len}, float32 stores, median of {WIDE_REPS})")
    rows.append(dict(name="psd_phase1_tiled", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/stft_export_tiled.cu",
                     replaces="fmcw_radar_processing_tpu/ops/stft_pallas.py:215",
                     max_abs_err=max(e[0] for e in k4_errs), ms=ms4a,
                     plain_ms=plain_ms4a, ms_second=second4a, ms_b2b=b2b4a,
                     bound=bound(f_len * 4 + 2 * f_nb_pad * 20 * 4
                                 + f_nb_pad * f_t_pad * 4
                                 + -(-f_nb_pad // 128) * f_t_pad // stc.PSD_TILE * 4,
                                 psd_ops(f_count - 19, f_nb_pad), "f32")))
    rows.append(dict(name="db_rescale_tiled", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/stft_export_tiled.cu",
                     replaces="fmcw_radar_processing_tpu/ops/stft_pallas.py:238",
                     max_abs_err=max(max(e[1:]) for e in k4_errs), ms=ms4b,
                     plain_ms=plain_ms4b, ms_second=second4b, ms_b2b=b2b4b,
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
    # The CPU reference with the card's pass semantics (rescale_precision
    # "high" is three bf16 passes there, exact float32 on the CPU).
    with mxu_predicate(lambda t: True):
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
    check(all(launches[k] == 1 for k in ("fast_time_profile_b3", "psd_phase1_b3",
                                         "db_rescale")),
          "K1a, K2a and K3 launched once each on the main path")
    for name in ("fast_time_profile", "psd_phase1", "psd_phase1_tiled",
                 "db_rescale_tiled"):
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

    # 5a'. The exact chain, impl "pallas_profile" (K1b, six bf16 passes)
    # with the exact export (stft_psd_precision "highest": K2b), on the same
    # recording, counted: detections equal the target frames and ranges the
    # injected range; its waterfall within 120 dB of the exact float32
    # profile; detections, ranges and speeds of the main path (bf16x3) equal
    # to it, and the main path's waterfall within 100 dB of it.
    xcfg = RadarConfig.create(default_device_config(),
                              AlgorithmConfig.production(stft_psd_precision="highest"))
    xpipe = RadarPipeline(xcfg, device=dev, impl="pallas_profile")
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
    check(x_launches == {k: int(k in ("fast_time_profile", "psd_phase1",
                                      "db_rescale")) for k in x_launches},
          "impl='pallas_profile', psd precision 'highest': K1b, K2b, K3 once "
          "each, no K1a or K2a")
    check(np.array_equal(xout.detected, present)
          and np.all(xout.target_range[0, xout.detected] == want_range)
          and np.all(xout.target_speed[0, xout.detected] == want_speed),
          f"exact chain: detected frames = target frames, ranges = {want_range}, "
          f"speeds = {want_speed}")
    x_snr = snr_db(xout.waterfall, prof_exact_host.T)  # the waterfall is (K, F)
    check(x_snr >= 120.0, f"exact chain waterfall {x_snr:.2f} dB vs the exact "
          "float32 profile (tol 120 dB)")
    print(f"[exact] detections = the target frames, ranges {want_range} m; "
          f"waterfall {x_snr:.2f} dB SNR against the exact float32 profile (tol "
          "120 dB)")
    del prof_exact_host
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
    check(b_launches == {k: int(k in ("fast_time_profile_bf16", "psd_phase1_b3",
                                      "db_rescale")) for k in b_launches},
          "impl='pallas_profile_bf16': K1c, K2a, K3 once each; nothing else")
    held_to_exact("impl='pallas_profile_bf16'", bout, xout, 0.001)
    b_snr = snr_db(bout.waterfall, xout.waterfall)
    print(f"[bf16] waterfall {b_snr:.2f} dB SNR against the exact chain's")
    del bout, bpipe

    # 5a''''. stft_psd_store="bfloat16" (the JAX package's bf16 PSD store)
    # on the production recording: K2a with its rounding flag, then K3,
    # counted and timed; its first 256 frames on the card against the CPU
    # plain path, one bf16 ulp above -120 dB as [small].
    qcfg = RadarConfig.create(default_device_config(),
                              AlgorithmConfig.production(stft_psd_store="bfloat16"))
    qpipe = RadarPipeline(qcfg, device=dev)
    got = qpipe.process_recording(s_raw, s_cal)
    want = RadarPipeline(qcfg, device="cpu", impl="pallas_profile_high"
                         ).process_recording(s_raw, s_cal)
    check(np.array_equal(got.detected, want.detected), "bf16 PSD small: detected")
    for name in ("spectrogram_intensity", "spectrogram_psd_db"):
        a = torch.as_tensor(getattr(got, name))
        b = torch.as_tensor(getattr(want, name))
        check(a.shape == b.shape, f"bf16 PSD small: {name} shape")
        tol = torch.maximum(bf16_ulp(torch.maximum(a.abs(), b.abs())),
                            torch.tensor(1e-3))
        check(bool(((a - b).abs() <= tol)[b > -120].all()),
              f"bf16 PSD small: {name} within one bf16 ulp above -120 dB")
    torch.cuda.synchronize()
    timer = StageTimer()
    _lib.reset_launches()
    t0 = time.perf_counter()
    qout = qpipe.process_recording(raw, calib, timer=timer)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    q_launches = dict(_lib.LAUNCHES)
    print(f"[bf16 psd] 256 frames on cuda match the CPU plain path; "
          f"process_recording stft_psd_store='bfloat16' {FRAMES} frames: "
          f"{seconds:.4f} s = {FRAMES / seconds:,.0f} frames/s end to end; "
          f"launches {q_launches}")
    print(timer.pretty())
    check(q_launches == {k: int(k in ("fast_time_profile_b3", "psd_phase1_b3",
                                      "db_rescale")) for k in q_launches},
          "stft_psd_store='bfloat16': K1a, K2a, K3 once each")
    check(np.array_equal(qout.detected, present), "bf16 PSD: detected frames")
    check(qout.spectrogram_intensity.shape == (1024, n_valid)
          and bool(np.isfinite(qout.spectrogram_intensity).all())
          and float(qout.spectrogram_psd_db.max()) == 0.0,
          "bf16 PSD: intensity finite, dB map normalized to 0 dB")
    del qout, qpipe

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
    for name in ("fast_time", "search_peaks_fused", "psd_phase1_b3", "db_rescale"):
        check(p_launches[name] > 0, f"{name} launched on the impl='pallas' path")
    check(p_launches["psd_phase1"] == 0, "K2b not launched on impl='pallas'")
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
        check(i_launches == {k: int(k in ("psd_phase1_b3", "db_rescale"))
                             for k in i_launches},
              f"impl={impl!r}: the export's K2a and K3 once, no frame-chain kernel")
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
    check(k5_launches == {k: int(k in ("psd_tmax", "db_rescale_recompute"))
                          for k in k5_launches},
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

    export = time_turns({"K2b+K3": materializing, "K5a+K5b": recompute,
                         "plain": plain})
    print(f"[time] export nfft 256, float32 dB, bf16 intensity: K2b+K3 "
          f"{export['K2b+K3']:.4f} ms, K5a+K5b {export['K5a+K5b']:.4f} ms, plain "
          f"{export['plain']:.4f} ms (in turns, median of {REPS})")
    ms5a, plain_ms5a, second5a, b2b5a = time_pair(
        lambda: stc.psd_tmax(sig, nv, a2, nb_pad, t_pad),
        lambda: stc.psd_tmax_ref(sig, nv, a2, nb_pad, t_pad))
    gmax_r = stc.psd_tmax(sig, nv, a2, nb_pad, t_pad).amax()
    ms5b, plain_ms5b, second5b, b2b5b = time_pair(
        lambda: stc.db_rescale_recompute(sig, nv, a2, gmax_r, nb, 1024, t_pad, bf16),
        lambda: stc.db_rescale_recompute_ref(sig, nv, a2, gmax_r, nb, 1024, t_pad,
                                             bf16))
    print(f"[time] K5a kernel {ms5a:.4f} ms (second in its turn {second5a:.4f}), "
          f"plain {plain_ms5a:.4f} ms; K5b kernel {ms5b:.4f} ms (second in its "
          f"turn {second5b:.4f}), plain {plain_ms5b:.4f} ms (median of {REPS})")
    rows.append(dict(name="psd_tmax", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/stft_export_tiled.cu",
                     replaces="fmcw_radar_processing_tpu/ops/stft_pallas.py:158",
                     max_abs_err=k5a_err, ms=ms5a, plain_ms=plain_ms5a,
                     ms_second=second5a, ms_b2b=b2b5a,
                     bound=bound(sig.numel() * 4 + a2.numel() * 4
                                 + t_pad // stc.PSD_TILE * 4,
                                 psd_ops(nv, nb_pad), "f32")))
    rows.append(dict(name="db_rescale_recompute", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/stft_export.cu",
                     replaces="fmcw_radar_processing_tpu/ops/stft_pallas.py:178",
                     max_abs_err=k5b_err, ms=ms5b, plain_ms=plain_ms5b,
                     ms_second=second5b, ms_b2b=b2b5b,
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
    check(stc.UNTILED_MAX_BINS < r_nb_pad <= stc.JAX_UNTILED_MAX_BINS,
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
    msta, plain_msta, secondta, b2bta = time_pair(
        lambda: stc.psd_tmax_tiled(sig, nv, r_a2, r_nb_pad, t_pad),
        lambda: stc.psd_tmax_ref(sig, nv, r_a2, r_nb_pad, t_pad))
    gmax_r = stc.psd_tmax_tiled(sig, nv, r_a2, r_nb_pad, t_pad).amax()
    mstb, plain_mstb, secondtb, b2btb = time_pair(
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
                     ms_second=secondta, ms_b2b=b2bta,
                     bound=bound(sig.numel() * 4 + r_a2.numel() * 4
                                 + r_blocks * t_pad // stc.PSD_TILE * 4,
                                 psd_ops(nv, r_nb_pad), "f32")))
    rows.append(dict(name="db_rescale_recompute_tiled", route="cuda",
                     source="fmcw_radar_processing_tpu_torch/csrc/stft_export_tiled.cu",
                     replaces="fmcw_radar_processing_tpu/ops/stft_pallas.py:178",
                     max_abs_err=ktb_err, ms=mstb, plain_ms=plain_mstb,
                     ms_second=secondtb, ms_b2b=b2btb,
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
    for name in ("fast_time_profile", "psd_phase1", "psd_phase1_b3", "db_rescale",
                 "psd_tmax_tiled", "db_rescale_recompute_tiled"):
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

    # 9. The classifier's training path.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        train_phase(dev, tmp, _lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 10. The parallel paths, the native reader and the profiler trace.
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        parallel_phase(dev, raw, calib, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 11. matmul_precision and rescale_precision on the card.
    prec = precision_phase(dev, raw, calib, present, _lib)

    # Launches of each kernel on the main path that drives it (the row's
    # "launches", that path named in "main_path"): the production
    # run for K1a, K2a, K3, the exact chain (impl "pallas_profile",
    # stft_psd_precision "highest") for K1b and K2b, the
    # impl "pallas_profile_bf16" run for K1c, the
    # fidelity run for K4a/K4b, the impl "pallas" run for K6/K7,
    # spectrogram(recompute=True) for K5a/K5b and, at nfft 1,000, for the
    # bin-blocked recompute pair.
    paths = {"fast_time_profile_b3": ("production", launches),
             "psd_phase1_b3": ("production", launches),
             "fast_time_profile_bf16": ("production impl='pallas_profile_bf16'",
                                        b_launches),
             "fast_time_profile": ("production impl='pallas_profile'", x_launches),
             "psd_phase1": ("production impl='pallas_profile', "
                            "stft_psd_precision='highest'", x_launches),
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
            ms_second_in_turn=r["ms_second"], ms_back_to_back=r["ms_b2b"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1], library_ms=None,
            library_note=r.get("library_note", NO_LIBRARY),
            **{k: r[k] for k in ("yardstick_ms", "fill_ms", "snr_db_vs_exact",
                                 "profiler_ms") if k in r},
            **parent_readings.get(r["name"], {})))
    # K1a also ran once a recording in [precision]'s three recordings.
    next(t for t in table if t["name"] == "fast_time_profile_b3")[
        "launches_precision_phase"] = sum(
            row["k1a_launches"] for row in prec["recording"].values())
    print(f"[time] back to back ({B2B_CALLS} calls after a warmup), ms: "
          + ", ".join(f"{r['name']} {r['ms_b2b']:.4f} (bound {r['bound'][0]:.4f})"
                      for r in rows))
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
