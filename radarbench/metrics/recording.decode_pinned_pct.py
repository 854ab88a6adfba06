"""The share of the recording's read-back that lands in page-locked host
memory: 100 × the program's counter ``recording.decode_pinned_bytes`` over
its counter ``recording.decode_copy_bytes`` (the bytes of the trimmed maps
that cross to the host), both summed over the traced slice, from the
program's collector (utils/observe.py::PROFILED), in %; None where the
program has no such counter."""


def read(ctx):
    from fmcw_radar_processing_tpu_torch.utils import observe

    collector = getattr(observe, "PROFILED", None)
    if collector is None:
        return None
    pinned = collector.records.get("recording.decode_pinned_bytes")
    copied = collector.records.get("recording.decode_copy_bytes")
    if pinned is None or copied is None or not copied.items:
        return None
    return 100.0 * (pinned.items or 0) / copied.items
