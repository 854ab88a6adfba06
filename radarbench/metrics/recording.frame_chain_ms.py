"""The program's StageTimer stage ``frame_chain`` (pipeline/recording.py,
synchronized to the device) per recording in the traced slice."""


def read(ctx):
    s = ctx["spans"].get("frame_chain")
    return 1e3 * s / ctx["items"] if s else None
