"""Signal processing: windows, fast-time (range), detection, slow-time
(Doppler) and STFT operators, as host NumPy builders plus PyTorch ops."""
