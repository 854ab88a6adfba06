"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``) behind
PyTorch wrappers: K1 ``fast_time_cuda.fast_time_profile`` and K6
``fast_time_cuda.fast_time`` (the range FFT stored too); K7
``detect_cuda.search_peaks_fused``; K2 ``stft_cuda.psd_phase1`` and K3
``stft_cuda.db_rescale`` (nfft ≤ 512); K4a ``stft_cuda.psd_phase1_tiled``
and K4b ``stft_cuda.db_rescale_tiled`` (any nfft); K5a ``stft_cuda.psd_tmax``
and K5b ``stft_cuda.db_rescale_recompute`` (the recompute export). Each
wrapper runs its plain PyTorch version for CPU tensors and launches its
kernel, or raises, for CUDA tensors. ``_lib.LAUNCHES`` counts the
launches."""
