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
of the repository's ``native/fmcw_json.cpp`` (a plain C library, built with
``g++`` into the port's gitignored ``build/`` at first use); without a
compiler, or without that file, the pure-Python path gives the same bytes.
"""

from __future__ import annotations

import ctypes
import json
import math
import threading
from typing import Any

import numpy as np

from fmcw_radar_processing_tpu_torch.utils.native_build import build_so

_native_lock = threading.Lock()
_native_lib: ctypes.CDLL | None | bool = None  # None=untried, False=failed


def _get_native() -> ctypes.CDLL | None:
    """Build+load the native JSON serializer (native/fmcw_json.cpp), or None.

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
            lib = build_so("fmcw_json.cpp", "libfmcw_json.so")
            lib.fmcw_json_f64_array.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_int64,
            ]
            lib.fmcw_json_f64_array.restype = ctypes.c_int64
            _native_lib = lib
            return lib
        except Exception:
            _native_lib = False
            return None


def _native_array_text(arr: np.ndarray, pretty: bool, level: int) -> str | None:
    """Render a float ndarray to JSON text natively, or None to fall back."""
    if arr.ndim not in (1, 2) or (arr.ndim == 2 and arr.shape[1] == 0):
        return None
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


def _dumps_flat_fast(obj: dict, pretty: bool) -> str | None:
    """Assemble a flat dict, rendering float arrays natively. None → fallback."""
    parts: list[str] = []
    for k, v in obj.items():
        if not isinstance(k, str):
            return None
        if isinstance(v, np.ndarray) and v.dtype.kind == "f" \
                and v.size >= _NATIVE_MIN_ELEMS:
            arr = v.reshape(-1) if v.ndim == 2 and 1 in v.shape else v
            text = _native_array_text(arr, pretty, level=1)
            if text is None:
                return None
        else:
            text = json.dumps(_sanitize(v), indent=2 if pretty else None)
            if pretty and "\n" in text:  # re-indent nested lines one level
                text = text.replace("\n", "\n  ")
        parts.append(f'{json.dumps(k)}: {text}')
    if not parts:
        return "{}"
    if pretty:
        return "{\n  " + ",\n  ".join(parts) + "\n}"
    return "{" + ", ".join(parts) + "}"


def write_json(path: str, obj: dict, pretty: bool = True) -> str:
    text = dumps_matlab(obj, pretty=pretty)
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return path
