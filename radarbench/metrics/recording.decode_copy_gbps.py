"""The rate of the recording's read-back: the program's counter
``recording.decode_copy_bytes`` (the bytes of the trimmed intensity and dB
maps copied to the host) over the host seconds of its span
``recording.decode_copy``, both summed over the traced slice, from the
program's collector (utils/observe.py::PROFILED), in GB/s; None where the
program has no such counter or span."""


def read(ctx):
    from fmcw_radar_processing_tpu_torch.utils import observe

    collector = getattr(observe, "PROFILED", None)
    if collector is None:
        return None
    nbytes = collector.records.get("recording.decode_copy_bytes")
    copy = collector.records.get("recording.decode_copy")
    if nbytes is None or copy is None or not nbytes.items or copy.seconds <= 0:
        return None
    return nbytes.items / copy.seconds / 1e9
