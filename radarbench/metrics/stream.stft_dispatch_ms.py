"""The program's span ``stream.stft``: process_window's batched STFT, dB,
carry and stacking of the results. Its host seconds per window in the
traced slice, on the profiler's clock, from the program's collector
(utils/observe.py::PROFILED); None where the program has no such span."""


def read(ctx):
    from fmcw_radar_processing_tpu_torch.utils import observe

    collector = getattr(observe, "PROFILED", None)
    rec = collector.records.get("stream.stft") if collector is not None else None
    return 1e3 * rec.seconds / ctx["items"] if rec is not None else None
