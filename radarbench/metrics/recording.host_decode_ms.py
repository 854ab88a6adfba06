"""The program's StageTimer stage ``host_decode`` (pipeline/recording.py,
synchronized to the device) per recording in the traced slice."""


def read(ctx):
    s = ctx["spans"].get("host_decode")
    return 1e3 * s / ctx["items"] if s else None
