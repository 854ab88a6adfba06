"""The program's span ``recording.chain_wait``: the host waiting at
process_recording's int(count_dev) for the frame chain's kernels. Its
host seconds per recording in the traced slice, on the profiler's clock,
from the program's collector (utils/observe.py::PROFILED); None where
the program has no such span."""


def read(ctx):
    from fmcw_radar_processing_tpu_torch.utils import observe

    collector = getattr(observe, "PROFILED", None)
    rec = collector.records.get("recording.chain_wait") if collector is not None else None
    return 1e3 * rec.seconds / ctx["items"] if rec is not None else None
