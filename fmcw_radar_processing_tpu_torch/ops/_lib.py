"""Build, load and count the CUDA kernels of ``csrc/``.

Each source is compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc`` per
source, all started together), and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs
at first use, into ``fmcw_radar_processing_tpu_torch/build/`` under a name
keyed by a hash of the sources, headers and flags, so an edited source
rebuilds and an unchanged one is reused. Nothing is built when the module
is imported.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a run can
reset it and read it back to show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("fast_time_wgmma.cu", "stft_export.cu", "stft_export_tiled.cu",
           "stft_psd_b3.cu", "detect.cu")
HEADERS = ("export_common.cuh",)
# No --use_fast_math: it flushes subnormals to zero (the 1e-45 floor of the
# dB map is subnormal) and swaps in approximate logf/sqrtf.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"fast_time_profile_b3": 0, "fast_time_profile": 0,
            "fast_time_profile_bf16": 0, "psd_phase1_b3": 0,
            "psd_phase1": 0, "db_rescale": 0,
            "psd_phase1_tiled": 0, "db_rescale_tiled": 0, "fast_time": 0,
            "search_peaks_fused": 0, "psd_tmax": 0, "db_rescale_recompute": 0,
            "psd_tmax_tiled": 0, "db_rescale_recompute_tiled": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def find_nvcc() -> str | None:
    """nvcc of the CUDA toolkit PyTorch finds (CUDA_HOME, CUDA_PATH, PATH or
    the default install location)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else ""
    return nvcc if os.path.exists(nvcc) else shutil.which("nvcc")


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfmcw_kernels_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, s + ".o") for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / s)]
                for s, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        # (command, stdout, stderr, exit code): communicate() waits first.
        steps = [(c, *p.communicate(), p.returncode)
                 for c, p in zip(cmds, procs)]
        tmp = os.path.join(work, path.name)
        if all(rc == 0 for *_, rc in steps):
            link = [nvcc, "-shared", "-o", tmp, *objs]
            proc = subprocess.run(link, capture_output=True, text=True)
            steps.append((link, proc.stdout, proc.stderr, proc.returncode))
        path.with_suffix(".log").write_text("".join(
            " ".join(c) + "\n" + out + err for c, out, err, _ in steps))
        for c, _, err, rc in steps:
            if rc != 0:
                raise KernelBuildError(
                    f"nvcc failed ({rc}) on {os.path.basename(c[-1])}:\n"
                    f"{err[-4000:]}")
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fast_time_profile_launch.argtypes = [p, p, p, p, i, i, p]
    lib.fast_time_profile_launch.restype = i
    lib.fast_time_profile_b3_launch.argtypes = [p, p, p, p, p, i, i, p]
    lib.fast_time_profile_b3_launch.restype = i
    lib.fast_time_profile_bf16_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.fast_time_profile_bf16_launch.restype = i
    lib.fast_time_profile_bf16_attributes.argtypes = [p, p, p]
    lib.fast_time_profile_bf16_attributes.restype = i
    lib.db_rescale_launch.argtypes = [p, p, p, p, p, i, i, i, p, i, p, i,
                                      f, f, f, f, p]
    lib.db_rescale_launch.restype = i
    lib.psd_phase1_tiled_launch.argtypes = [p, i, p, i, p, p, i, i, i, p]
    lib.psd_phase1_tiled_launch.restype = i
    lib.psd_phase1_b3_launch.argtypes = [p, i, p, i, p, p, i, i, i, p]
    lib.psd_phase1_b3_launch.restype = i
    lib.db_rescale_tiled_launch.argtypes = [p, p, p, p, p, p, i, i, p, i, p, i,
                                            f, f, f, f, p]
    lib.db_rescale_tiled_launch.restype = i
    lib.fast_time_launch.argtypes = [p, p, p, p, p, i, i, p]
    lib.fast_time_launch.restype = i
    lib.search_peaks_launch.argtypes = [p, p, f, i, i, i, p, p, p, p]
    lib.search_peaks_launch.restype = i
    lib.db_rescale_recompute_launch.argtypes = [p, i, p, i, i, p, p, p, p, i,
                                                i, p, p, i, f, f, f, f, p]
    lib.db_rescale_recompute_launch.restype = i
    lib.psd_tmax_tiled_launch.argtypes = [p, i, p, i, p, i, i, p]
    lib.psd_tmax_tiled_launch.restype = i
    lib.db_rescale_recompute_tiled_launch.argtypes = [p, i, p, i, i, p, p, p, p,
                                                      p, i, p, p, i, f, f, f, f,
                                                      p]
    lib.db_rescale_recompute_tiled_launch.restype = i


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` on first use."""
    global _lib
    if _lib is not None:  # the common case: no lock on the launch path
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _lib = lib
        return _lib


@functools.lru_cache(maxsize=16)
def sm_count(device) -> int:
    """The number of streaming multiprocessors of the CUDA ``device``."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def check_operand(name: str, t, device, dtype) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned ``dtype`` tensor
    on the CUDA ``device`` — what every kernel of ``csrc/`` takes."""
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be on {device}")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def check_launch(name: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error; else count the launch."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
