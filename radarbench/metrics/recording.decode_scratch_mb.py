"""The device memory that the recording's read-back holds beyond the maps:
the program's counter ``recording.decode_scratch_bytes`` (the bytes of the
device slot that each block of rows is widened into before its copy to
the host), summed over the traced slice, per recording, in MB, from the
program's collector (utils/observe.py::PROFILED); None where the program
has no such counter."""


def read(ctx):
    from fmcw_radar_processing_tpu_torch.utils import observe

    collector = getattr(observe, "PROFILED", None)
    rec = (collector.records.get("recording.decode_scratch_bytes")
           if collector is not None else None)
    return rec.items / ctx["items"] / 1e6 if rec is not None and rec.items else None
