"""The program's span ``recording.decode_widen``: the widening of the
copied maps to float32 on the host, inside the stage host_decode. Its
host seconds per recording in the traced slice, on the profiler's clock,
from the program's collector (utils/observe.py::PROFILED); None where
the program has no such span."""


def read(ctx):
    from fmcw_radar_processing_tpu_torch.utils import observe

    collector = getattr(observe, "PROFILED", None)
    rec = collector.records.get("recording.decode_widen") if collector is not None else None
    return 1e3 * rec.seconds / ctx["items"] if rec is not None else None
