"""Frame chain, slow-time packing, the recording pipeline, the streaming
multi-channel processor, JSON payloads and the spectrogram PNG."""
