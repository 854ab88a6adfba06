"""Sanitizer harness for the streaming JSON writer (native/fmcw_json_stream.cpp).

Builds native/json_stream_self_test.cpp, which includes the writer, with
small chunks so that a few thousand values span many blocks, once with
AddressSanitizer + UBSan and once with ThreadSanitizer (where the
toolchain builds and runs a threaded program under it), and runs each
binary: an out-of-bounds access, a leak, UB, a data race in the worker
ring, a deadlock (the time limit) or bytes that differ from
fmcw_json_f64_array's fail the test.
"""

import os
import shutil
import subprocess

import pytest

_NATIVE = os.path.join(os.path.dirname(__file__), "..", "native")
_FLAGS = {
    "asan_ubsan": ["-fsanitize=address,undefined", "-fno-omit-frame-pointer"],
    "tsan": ["-fsanitize=thread"],
}
_TSAN_PROBE = """
#include <thread>
int main() { int x = 0; std::thread t([&] { x = 1; }); t.join(); return x - 1; }
"""

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="no C++ toolchain"
)


def _build(src, out, flags):
    return subprocess.run(
        ["g++", "-O1", "-g", "-std=c++17", "-pthread", *flags, src, "-o", out],
        capture_output=True, text=True,
    )


@pytest.mark.parametrize("sanitizer", sorted(_FLAGS))
def test_json_stream_self_test_under_sanitizer(sanitizer, tmp_path):
    if sanitizer == "tsan":
        probe = tmp_path / "probe.cpp"
        probe.write_text(_TSAN_PROBE)
        built = _build(str(probe), str(tmp_path / "probe"), _FLAGS["tsan"])
        if built.returncode != 0 or subprocess.run(
                [str(tmp_path / "probe")], capture_output=True, timeout=60).returncode:
            pytest.skip("this toolchain builds or runs no ThreadSanitizer program")
    binary = str(tmp_path / "json_stream_self_test")
    built = _build(os.path.join(_NATIVE, "json_stream_self_test.cpp"), binary,
                   [*_FLAGS[sanitizer], "-DFMCW_JSON_STREAM_CHUNK=512"])
    assert built.returncode == 0, built.stderr
    env = dict(os.environ,
               TMPDIR=str(tmp_path),
               ASAN_OPTIONS="detect_leaks=1:abort_on_error=0",
               UBSAN_OPTIONS="halt_on_error=1",
               TSAN_OPTIONS="halt_on_error=1")
    res = subprocess.run([binary], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "all checks passed" in res.stdout
    assert "WARNING" not in res.stderr and "ERROR" not in res.stderr
