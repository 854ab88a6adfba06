"""fmcw_radar_processing_tpu_torch — the FMCW radar chain on PyTorch and CUDA.

A port of ``fmcw_radar_processing_tpu`` (JAX on a TPU) to PyTorch on an
NVIDIA H100. The JAX package stays the reference; this package mirrors its
layout so each module has an obvious counterpart:

config    not copied — the jax-free ``fmcw_radar_processing_tpu.config``
          is shared (RadarConfig, AlgorithmConfig, XML loaders)
dsp       windows, fast-time (range) chain, detection, slow-time, STFT
ops       hand-written CUDA kernels (sources in ``csrc/``) behind wrappers
          that run the plain PyTorch version for CPU tensors
pipeline  frame chain, slow-time packing, recording pipeline, streaming
          multi-channel processor, payloads, PNG
models    VGG16 / SmallCNN classifiers, Flax weight carrier, inference
serve     service handler, HTTP service with the /classify batcher,
          dashboard and CLI
utils     complex-as-pair helpers, stage timers

The package imports ``torch`` and never ``jax``. From the JAX package it
imports only jax-free modules: ``config``, ``io.raw_format``,
``io.synth``, ``io.storage`` and ``utils.jsonio``. The configuration and
recording I/O names a caller needs are re-exported here, so that code
driving the port imports only the port.
"""

__version__ = "0.1.0"

from fmcw_radar_processing_tpu.config import (  # noqa: F401
    AlgorithmConfig,
    RadarConfig,
    default_device_config,
)
from fmcw_radar_processing_tpu.io.raw_format import write_recording  # noqa: F401
from fmcw_radar_processing_tpu.io.storage import LocalStorage  # noqa: F401
from fmcw_radar_processing_tpu.io.synth import (  # noqa: F401
    SyntheticTarget,
    synthesize_recording,
)
