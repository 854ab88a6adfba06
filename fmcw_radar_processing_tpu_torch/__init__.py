"""fmcw_radar_processing_tpu_torch — the FMCW radar chain on PyTorch and CUDA.

A port of ``fmcw_radar_processing_tpu`` (JAX on a TPU) to PyTorch on an
NVIDIA H100. The JAX package stays the reference; this package mirrors its
layout so each module has an obvious counterpart:

config    RadarConfig, AlgorithmConfig (with production()), DeviceConfig,
          DerivedParams, the XML loaders
io        the raw recording container, synthetic recordings, storage
dsp       windows, fast-time (range) chain, detection, slow-time, STFT
ops       hand-written CUDA kernels (sources in ``csrc/``) behind wrappers
          that run the plain PyTorch version for CPU tensors
pipeline  frame chain, slow-time packing, recording pipeline, streaming
          multi-channel processor, payloads, PNG
models    VGG16 / SmallCNN classifiers, Flax weight carrier, inference
serve     service handler, HTTP service with the /classify batcher,
          dashboard and CLI
utils     complex-as-pair helpers, MATLAB-compatible JSON, stage timers

The package imports ``torch`` and nothing of ``jax`` or of the JAX
package: ``config``, ``io`` and ``utils.jsonio`` are its own copies, equal
to the JAX modules field for field and byte for byte. Its entry points run
on the card (``device="cuda"``) unless the caller passes ``device="cpu"``.
The configuration and recording I/O names a caller needs are re-exported
here.
"""

__version__ = "0.1.0"

from fmcw_radar_processing_tpu_torch.config import (  # noqa: F401
    AlgorithmConfig,
    RadarConfig,
    default_device_config,
)
from fmcw_radar_processing_tpu_torch.io.raw_format import write_recording  # noqa: F401
from fmcw_radar_processing_tpu_torch.io.storage import LocalStorage  # noqa: F401
from fmcw_radar_processing_tpu_torch.io.synth import (  # noqa: F401
    SyntheticTarget,
    synthesize_recording,
)
