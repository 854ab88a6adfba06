"""The program's StageTimer stage ``payload_build`` (pipeline/recording.py,
synchronized to the device) per recording in the traced slice."""


def read(ctx):
    s = ctx["spans"].get("payload_build")
    return 1e3 * s / ctx["items"] if s else None
