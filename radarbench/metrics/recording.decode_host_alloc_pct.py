"""The page-locked host memory under the recording's read-back against the
maps it holds: 100 × the program's counter
``recording.decode_host_alloc_bytes`` (the bytes of the page-locked host
blocks that the outputs occupy, after any rounding, new or reused) over
its counter ``recording.decode_copy_bytes`` (the bytes of the trimmed maps
that cross to the host), both summed over the traced slice, from the
program's collector (utils/observe.py::PROFILED), in %; None where the
program has no such counter."""


def read(ctx):
    from fmcw_radar_processing_tpu_torch.utils import observe

    collector = getattr(observe, "PROFILED", None)
    if collector is None:
        return None
    alloc = collector.records.get("recording.decode_host_alloc_bytes")
    copied = collector.records.get("recording.decode_copy_bytes")
    if alloc is None or copied is None or not copied.items:
        return None
    return 100.0 * (alloc.items or 0) / copied.items
