"""The program's StageTimer stage ``stft`` (the export, ops/stft_cuda.py,
synchronized to the device) per recording in the traced slice."""


def read(ctx):
    s = ctx["spans"].get("stft")
    return 1e3 * s / ctx["items"] if s else None
