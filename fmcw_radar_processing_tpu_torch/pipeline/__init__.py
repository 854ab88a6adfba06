"""Frame chain, slow-time packing, the recording pipeline, JSON payloads
and the spectrogram PNG."""
