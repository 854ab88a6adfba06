"""MATLAB-``jsonencode``-compatible JSON emission.

The dashboard consumes JSON produced by MATLAB's ``jsonencode(...,
'PrettyPrint', true)`` (radar_processing.m:315,364,392,425,590). The
encoding rules that matter for schema compatibility:

  * row and column vectors encode as flat arrays; true matrices encode as
    arrays of rows;
  * NaN/±Inf encode as ``null``;
  * scalars encode as numbers, strings as strings.

This module reproduces those rules for NumPy inputs.

The port's own copy of the JAX package's ``utils/jsonio.py``: its output is
the same, byte for byte. Large float arrays go through the C++ serializer
of the repository's ``native/fmcw_json.cpp``, which ``native/
fmcw_json_stream.cpp`` includes (one plain C library, built with ``g++``
into the port's gitignored ``build/`` at first use); without a compiler,
or without those files, the pure-Python path gives the same bytes.
:func:`write_json` streams each large float array from the native writer
straight into the file, formatted on up to ``torch.get_num_threads()``
threads, and writes the rest of the object around it.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import threading
from typing import Any

import numpy as np
import torch

from fmcw_radar_processing_tpu_torch.utils.native_build import build_so

_native_lock = threading.Lock()
_native_lib: ctypes.CDLL | None | bool = None  # None=untried, False=failed


def _get_native() -> ctypes.CDLL | None:
    """Build+load the native JSON serializer and its streaming writer
    (native/fmcw_json_stream.cpp, which includes native/fmcw_json.cpp), or
    None.

    Built on first use; any failure (no compiler, no source, read-only
    tree) selects the pure-Python path, which gives the same bytes.
    """
    global _native_lib
    with _native_lock:
        if _native_lib is False:
            return None
        if _native_lib is not None:
            return _native_lib
        try:
            lib = build_so("fmcw_json_stream.cpp", "libfmcw_json_stream.so")
            lib.fmcw_json_f64_array.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_int64,
            ]
            lib.fmcw_json_f64_array.restype = ctypes.c_int64
            lib.fmcw_json_stream.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.fmcw_json_stream.restype = ctypes.c_int64
            _native_lib = lib
            return lib
        except Exception:
            _native_lib = False
            return None


def _native_array_text(arr: np.ndarray, pretty: bool, level: int) -> str | None:
    """Render a 1-D, or 2-D with columns, float ndarray to JSON text
    natively, or None to fall back."""
    lib = _get_native()
    if lib is None:
        return None
    a = np.ascontiguousarray(arr, dtype=np.float64)
    rows, cols = (a.shape[0], 0) if a.ndim == 1 else a.shape
    n = max(a.size, 1)
    per = 32 + (2 * (level + 3) + 2 if pretty else 2)
    cap = n * per + (rows + 2) * (2 * (level + 2) + 4) + 64
    buf = ctypes.create_string_buffer(cap)
    written = lib.fmcw_json_f64_array(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rows, cols, int(pretty), level, buf, cap,
    )
    if written < 0:
        return None
    return buf.raw[:written].decode("ascii")


def _sanitize_array(arr: np.ndarray) -> list:
    """Vectorized ndarray → JSON-ready nested lists.

    Per-element Python checks on multi-million-cell spectrogram matrices
    were the pipeline's measured bottleneck (61% of wall in --profile);
    non-finite masking is done once in NumPy instead.
    """
    if arr.ndim == 2 and 1 in arr.shape:
        arr = arr.reshape(-1)  # MATLAB: vectors are flat arrays
    if arr.dtype.kind == "f":
        finite = np.isfinite(arr)
        if finite.all():
            return arr.tolist()
        out = arr.astype(object)
        out[~finite] = None
        return out.tolist()
    if arr.dtype.kind in "iub":
        return arr.tolist()
    return [_sanitize(v) for v in arr.tolist()]


def _sanitize(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _sanitize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_sanitize(v) for v in value]
    if isinstance(value, np.ndarray):
        return _sanitize_array(value)
    if isinstance(value, (np.floating, float)):
        f = float(value)
        return None if (math.isnan(f) or math.isinf(f)) else f
    if isinstance(value, (np.integer, int)):
        return int(value)
    if isinstance(value, (np.bool_, bool)):
        return bool(value)
    return value


def dumps_matlab(obj: dict, pretty: bool = True) -> str:
    """pretty=True matches the reference's 'PrettyPrint' output layout.

    Flat payload dicts (the four reference schemas) take a fast path: big
    float arrays are rendered by the native serializer (shortest
    round-trip formatting — values parse back identical to json.dumps
    output) and spliced between json.dumps-rendered scalar fields.
    """
    if isinstance(obj, dict):
        text = _dumps_flat_fast(obj, pretty)
        if text is not None:
            return text
    return json.dumps(_sanitize(obj), indent=2 if pretty else None)


_NATIVE_MIN_ELEMS = 512  # below this, tolist+dumps wins (no buffer setup)


def _native_operand(value: Any) -> np.ndarray | None:
    """The array the native serializer renders for a field's value (a row
    or column vector flattened, as MATLAB encodes it), or None where the
    value goes through json.dumps."""
    if not (isinstance(value, np.ndarray) and value.dtype.kind == "f"
            and value.size >= _NATIVE_MIN_ELEMS):
        return None
    return value.reshape(-1) if value.ndim == 2 and 1 in value.shape else value


def _field_text(value: Any, pretty: bool) -> str:
    """A field's value through json.dumps, nested lines indented one level."""
    text = json.dumps(_sanitize(value), indent=2 if pretty else None)
    if pretty and "\n" in text:  # re-indent nested lines one level
        text = text.replace("\n", "\n  ")
    return text


def _flat_parts(obj: dict, pretty: bool) -> list[str | np.ndarray] | None:
    """A flat dict's JSON cut into its text, every field rendered by
    json.dumps, and between the pieces each float array that the native
    serializer renders. None → fallback (a key that is not a string, or
    such an array of a shape the serializer does not take)."""
    if not obj:
        return ["{}"]
    parts: list[str | np.ndarray] = []
    text = ["{\n  " if pretty else "{"]
    for i, (k, v) in enumerate(obj.items()):
        if not isinstance(k, str):
            return None
        if i:
            text.append(",\n  " if pretty else ", ")
        text.append(f"{json.dumps(k)}: ")
        arr = _native_operand(v)
        if arr is None:
            text.append(_field_text(v, pretty))
        elif arr.ndim > 2 or arr.shape[-1] == 0:  # the serializer's shapes
            return None
        else:
            parts += ["".join(text), arr]
            text = []
    text.append("\n}" if pretty else "}")
    parts.append("".join(text))
    return parts


def _dumps_flat_fast(obj: dict, pretty: bool) -> str | None:
    """Assemble a flat dict, rendering float arrays natively. None → fallback."""
    parts = _flat_parts(obj, pretty)
    if parts is None:
        return None
    out = []
    for part in parts:
        if isinstance(part, np.ndarray):
            part = _native_array_text(part, pretty, level=1)
            if part is None:
                return None
        out.append(part)
    return "".join(out)


def _stream_operand(arr: np.ndarray) -> np.ndarray:
    """``arr`` as ``fmcw_json_stream`` reads it: native float32 or float64,
    C-contiguous (other floats widened to float64, as the buffer path does)."""
    if arr.dtype not in (np.float32, np.float64):
        arr = arr.astype(np.float64)
    return np.ascontiguousarray(arr)


def _write_all(fd: int, data: bytes) -> None:
    view = memoryview(data)
    while view:
        view = view[os.write(fd, view):]


def write_json_counts(path: str, obj: dict, pretty: bool = True) -> tuple[int, int]:
    """Write ``obj`` to ``path`` as :func:`dumps_matlab` renders it; returns
    the bytes written and how many of them the native stream wrote.

    Each float array that the native serializer takes is streamed into the
    file by ``fmcw_json_stream`` (bounded chunks, up to
    ``torch.get_num_threads()`` formatting threads), with the text around
    it written from Python. If the native writer fails, the file is
    rewritten whole through :func:`dumps_matlab`: the same bytes, and none
    of them streamed.
    """
    parts = _flat_parts(obj, pretty) if isinstance(obj, dict) else None
    lib = _get_native() if parts is not None and len(parts) > 1 else None
    if lib is None:
        text = dumps_matlab(obj, pretty=pretty)
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
        return os.path.getsize(path), 0
    parts = [part.encode("utf-8") if isinstance(part, str) else _stream_operand(part)
             for part in parts]
    threads = torch.get_num_threads()
    with open(path, "wb", buffering=0) as f:
        fd = f.fileno()
        written = streamed = 0
        for part in parts:
            if isinstance(part, bytes):
                _write_all(fd, part)
                written += len(part)
                continue
            rows, cols = (part.shape[0], 0) if part.ndim == 1 else part.shape
            n = lib.fmcw_json_stream(part.ctypes.data, part.itemsize, rows, cols,
                                     int(pretty), 1, fd, threads)
            if n < 0:
                f.seek(0)
                f.truncate()
                data = dumps_matlab(obj, pretty=pretty).encode("utf-8")
                _write_all(fd, data)
                return len(data), 0
            written += n
            streamed += n
    return written, streamed


def write_json(path: str, obj: dict, pretty: bool = True) -> int:
    """Write ``obj`` to ``path`` as :func:`dumps_matlab` renders it; returns
    the bytes written."""
    return write_json_counts(path, obj, pretty)[0]
