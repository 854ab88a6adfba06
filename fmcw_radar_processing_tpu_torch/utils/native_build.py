"""Build and load a C++ source of the repository's ``native/`` as a plain C
library (``utils/jsonio.py``'s serializer, ``io/native_loader.py``'s
reader).

The library goes into the port's gitignored ``build/`` and is rebuilt
when missing or older than its source. The build writes a temporary file
and renames it with ``os.replace``, so concurrent processes never load a
half-written library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "build")


def build_so(source: str, library: str) -> ctypes.CDLL:
    """Load ``build/<library>``, first compiling ``native/<source>`` with
    ``g++ -O3 -shared -pthread`` when needed. Raises when the build fails (no
    compiler, no source) or the library does not load."""
    src = os.path.abspath(os.path.join(NATIVE_DIR, source))
    so = os.path.join(BUILD_DIR, library)
    if not os.path.exists(so) or (
        os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(so)
    ):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        "-pthread", src, "-o", tmp],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, so)  # atomic for concurrent builders
    return ctypes.CDLL(so)
