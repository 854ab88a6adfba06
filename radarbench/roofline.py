"""The least time of each entry's required work on one card.

Bytes: each input byte read once and each output the entry returns written
once, in the dtype the configuration stores it in. Operations: the
transforms the function needs, counted as FFTs (5·N·log2 N for a complex
length-N transform, half that for a real one), plus the log-frequency
interpolation (3 per output value), against the float32 peak. Neither
count looks at which kernels run, so a fused, swapped or dropped kernel
leaves it as it is. The least time is the larger of bytes over the peak
bandwidth and operations over the peak rate; ``bound`` says which.

The STFT's nfft is the configuration's ``stft_nfft``, or where that is
null (the fidelity profile, the bare ``AlgorithmConfig``) the program's
rule: the next power of two of the packed signal's valid samples, which
at hop 1 are the columns plus the window less one.

``recording_work`` and ``activity_work`` give beside their totals the
share of the spectrogram export alone, under "export".

``vgg16_work`` counts a classifier's forward: 2 operations a multiply-add
of its convolutions and Dense layers, against the bf16 peak it computes
in; bytes of each layer's input and output in bf16, and the weights in
bf16 once a forward.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, at the 700 W limit).
"""

from __future__ import annotations

import math

from radarbench.reference.compare import next_pow2

PEAKS = {"bytes_per_s": 3.35e12, "float32_flop_per_s": 67e12,
         "bfloat16_flop_per_s": 989e12}
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def fft_flops(n: int, count: int, real: bool = False) -> float:
    f = 5.0 * n * math.log2(n) * count
    return f / 2 if real else f


def stft_nfft(cfg: dict, columns: int) -> int:
    """The nfft of an export of ``columns`` hop-1 columns: ``stft_nfft``
    where the configuration sets it, else next_pow2(columns + W − 1), as
    the program picks it from its valid sample count."""
    alg = cfg["algorithm"]
    if alg["stft_nfft"]:
        return alg["stft_nfft"]
    if (alg["stft_hop"] or 1) != 1:
        raise ValueError(f"{cfg['name']}: a null stft_nfft at "
                         f"stft_hop {alg['stft_hop']}; its columns do not fix the "
                         "sample count the nfft follows")
    return next_pow2(columns + alg["stft_window_length"] - 1)


def least_seconds(nbytes: float, flops: float,
                  flop_peak: str = "float32_flop_per_s") -> tuple[float, str]:
    tb = nbytes / PEAKS["bytes_per_s"]
    tf = flops / PEAKS[flop_peak]
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _chain(cfg: dict, frames: int) -> tuple[float, float]:
    """(input bytes, operations) of the per-frame chain over ``frames``."""
    dev, alg = cfg["device"], cfg["algorithm"]
    nts, pn = dev["num_samples_per_chirp"], dev["num_chirps_per_frame"]
    raw = frames * pn * 2 * nts * 4 + 2 * nts * 4
    ops = (fft_flops(alg["range_fft_size"], frames * pn)
           + fft_flops(alg["doppler_fft_size"], frames))
    return raw, ops


def _export(cfg: dict, columns: int, nfft: int, db_dtype: str | None,
            int_dtype: str) -> tuple[float, float]:
    """(output bytes, operations) of a spectrogram export of ``columns``."""
    alg = cfg["algorithm"]
    nb = nfft // 2 + 1
    out = alg["max_freq_bins"] * columns * DTYPE_BYTES[int_dtype]
    if db_dtype is not None:
        out += nb * columns * DTYPE_BYTES[db_dtype]
    ops = fft_flops(nfft, columns, real=True) + 3 * alg["max_freq_bins"] * columns
    return out, ops


def recording_work(cfg: dict, frames: int, columns: int, ranks: int = 1) -> dict:
    """One recording through the 'no' entry: raw in; waterfall, range,
    speed, strength, detected, dB map and intensity out. With ``ranks``
    the work of one rank (an equal share)."""
    alg = cfg["algorithm"]
    k = alg["range_fft_size"]
    raw, ops = _chain(cfg, frames)
    sharded = ranks > 1  # the sharded export keeps float32 maps
    out, eops = _export(cfg, columns, stft_nfft(cfg, columns),
                        "float32" if sharded else alg["stft_db_store"],
                        "float32" if sharded else alg["intensity_dtype"])
    nbytes = raw + frames * (k * 4 + 3 * 4 + 1) + out
    return {"bytes": nbytes / ranks, "flops": (ops + eops) / ranks,
            "export": {"bytes": out / ranks, "flops": eops / ranks}}


def activity_work(cfg: dict, frames: int, batch_columns: list[int]) -> dict:
    """One recording through the 'yes' entry: raw in, the batch
    spectrograms' intensity out."""
    alg = cfg["algorithm"]
    raw, ops = _chain(cfg, frames)
    xbytes = xops = 0
    for cols in batch_columns:
        out, eops = _export(cfg, cols, stft_nfft(cfg, cols), None, alg["intensity_dtype"])
        xbytes += out
        xops += eops
    return {"bytes": raw + xbytes, "flops": ops + xops,
            "export": {"bytes": xbytes, "flops": xops}}


def stream_window_work(cfg: dict) -> dict:
    """One streamed window of every channel: raw in; per channel the
    waterfall, range, speed, strength, detected, and the PSD and dB map
    over the window's column capacity (float32), out."""
    dev, alg = cfg["device"], cfg["algorithm"]
    c, f = cfg["channels"], cfg["window_frames"]
    pn, k = dev["num_chirps_per_frame"], alg["range_fft_size"]
    raw, ops = _chain(cfg, f)
    cols = f * pn
    nb = cfg["nfft"] // 2 + 1
    out = f * (k * 4 + 3 * 4 + 1) + 2 * nb * cols * 4
    ops += fft_flops(cfg["nfft"], cols, real=True)
    return {"bytes": c * (raw + out), "flops": c * ops}


def vgg16_work(input_shape, blocks, head: int, images: int, forwards: int = 1) -> dict:
    """``images`` NHWC images of ``input_shape`` through a VGG backbone of
    ``blocks`` ((convolutions, channels) per block: 3×3 'SAME'
    convolutions and ReLU, then a 2×2 max-pool) and the head Flatten →
    Dense(``head``) → Dense(1), in ``forwards`` forwards. Bytes: the
    float32 images read once, each convolution's, pool's and Dense's input
    and output once in bf16, the logits in float32, and the weights in
    bf16 once a forward. Only these images are counted: rows a program
    pads a batch with are its own waste."""
    h, w, cin = input_shape
    act = flops = params = 0
    for convs, ch in blocks:
        for _ in range(convs):
            flops += 2 * h * w * 9 * cin * ch
            act += h * w * (cin + ch)
            params += 9 * cin * ch + ch
            cin = ch
        act += h * w * ch + (h // 2) * (w // 2) * ch  # the pool
        h, w = h // 2, w // 2
    feats = h * w * cin
    flops += 2 * (feats * head + head)
    act += feats + head + head
    params += feats * head + head + head + 1
    pixels = input_shape[0] * input_shape[1] * input_shape[2]
    nbytes = images * (4 * pixels + 2 * act + 4) + forwards * 2 * params
    return {"bytes": float(nbytes), "flops": float(images * flops),
            "flop_peak": "bfloat16_flop_per_s"}
