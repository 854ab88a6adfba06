"""ctypes bindings of the native C++ recording reader (native/fmcw_io.cpp).

The streaming data loader: it reads only the requested frame window of
the requested antenna and writes the chain's pair layout directly —
constant memory for a recording of any length, no whole-file
``np.frombuffer`` and no transpose or copy chain. The JAX package's
``io/native_loader.py`` with the same C ABI.

The library is built with ``g++`` on first use into the port's own
``build/`` directory, atomically (utils/native_build.py). Without a
compiler :func:`native_available` is False and
io/raw_format.py::load_recording_for_chain reads with NumPy, the JAX
package's semantics for a host reader.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from fmcw_radar_processing_tpu_torch.utils.native_build import build_so

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LIB_ERR: str | None = None


def _build_and_load() -> ctypes.CDLL:
    lib = build_so("fmcw_io.cpp", "libfmcw_io.so")
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.fmcw_parse_header.argtypes = [ctypes.c_char_p, u32p]
    lib.fmcw_parse_header.restype = ctypes.c_int
    lib.fmcw_read_calib.argtypes = [ctypes.c_char_p, ctypes.c_uint32, f32p]
    lib.fmcw_read_calib.restype = ctypes.c_int
    lib.fmcw_read_frames_pair.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, f32p,
    ]
    lib.fmcw_read_frames_pair.restype = ctypes.c_int
    lib.fmcw_calib_vector_pair.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32, f32p,
    ]
    lib.fmcw_calib_vector_pair.restype = ctypes.c_int
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The loaded native library, or None if unavailable (no compiler)."""
    global _LIB, _LIB_ERR
    with _LOCK:
        if _LIB is None and _LIB_ERR is None:
            try:
                _LIB = _build_and_load()
            except Exception as e:  # noqa: BLE001 — the NumPy reader instead
                _LIB_ERR = str(e)
        return _LIB


def native_available() -> bool:
    return get_lib() is not None


class NativeRecordingReader:
    """Streaming reader over a .raw.bin file via the C++ runtime.

    Usage:
        r = NativeRecordingReader(path)
        pair = r.read_frames(start, count, rx=0)   # [count, PN, NTS, 2] f32
        calib = r.calib_vector_pair(rx=0, nts=64)  # [NTS, 2] f32
    """

    def __init__(self, path: str):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native IO unavailable: {_LIB_ERR}")
        self._lib = lib
        self._path = path.encode()
        hdr = np.zeros(7, np.uint32)
        rc = lib.fmcw_parse_header(
            self._path, hdr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        if rc != 0:
            raise ValueError(f"failed to parse {path}: rc={rc}")
        (self.version, self.frame_count, self.num_rx, self.n_cal,
         self.pn, self.nts, self.flags) = (int(x) for x in hdr)

    @property
    def is_complex(self) -> bool:
        return bool(self.flags & 1)

    def read_frames(self, start: int, count: int, rx: int = 0) -> np.ndarray:
        out = np.empty((count, self.pn, self.nts, 2), np.float32)
        rc = self._lib.fmcw_read_frames_pair(
            self._path, start, count, rx,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise IOError(f"read_frames({start}, {count}, rx={rx}) rc={rc}")
        return out

    def calib_vector_pair(self, rx: int = 0, nts: int | None = None) -> np.ndarray:
        nts = nts or self.nts
        out = np.empty((nts, 2), np.float32)
        rc = self._lib.fmcw_calib_vector_pair(
            self._path, rx, nts, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise IOError(f"calib_vector_pair(rx={rx}) rc={rc}")
        return out

    def iter_batches(self, batch_frames: int, rx: int = 0):
        """Yield (start_frame, pair_batch) windows over the recording."""
        for start in range(0, self.frame_count, batch_frames):
            count = min(batch_frames, self.frame_count - start)
            yield start, self.read_frames(start, count, rx)
