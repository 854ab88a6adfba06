"""The program's span ``stream.upload``: the window's raw and calib sent to
the card and reshaped in StreamingProcessor.process_window. Its host
seconds per window in the traced slice, on the profiler's clock, from
the program's collector (utils/observe.py::PROFILED); None where the
program has no such span."""


def read(ctx):
    from fmcw_radar_processing_tpu_torch.utils import observe

    collector = getattr(observe, "PROFILED", None)
    rec = collector.records.get("stream.upload") if collector is not None else None
    return 1e3 * rec.seconds / ctx["items"] if rec is not None else None
