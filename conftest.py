"""Build the native libraries once, before any pytest-xdist worker starts.

The JAX package's loaders (``io/native_loader.py``, ``utils/jsonio.py``)
compile ``native/*.cpp`` with ``g++ -o`` straight into ``native/build/`` on
first use. When several workers of a fresh checkout reach that point
together, one can load the half-written library of another ("file too
short"); its loader then records the failure for the rest of that
worker, and the native tests there skip or fail. Calling the loaders here,
in the controller process (or the only process, without xdist), leaves
finished libraries on disk for every worker to load. The port's loaders
build atomically already; they are called too, so that no worker pays for
the build. Nothing is caught here: without ``g++`` each loader's own
fallback decides, as it does inside a test.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built
        return
    from fmcw_radar_processing_tpu.io import native_loader
    from fmcw_radar_processing_tpu.utils import jsonio
    from fmcw_radar_processing_tpu_torch.io import native_loader as port_native_loader
    from fmcw_radar_processing_tpu_torch.utils import jsonio as port_jsonio

    native_loader.native_available()
    jsonio._get_native()
    port_native_loader.native_available()
    port_jsonio._get_native()
