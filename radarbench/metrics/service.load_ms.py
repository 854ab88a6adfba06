"""The program's span ``service.load``: the recording's load: the XML, the
native reader and the reshape to pair rows
(serve/handler.py::load_recording). Its host seconds per call in the
traced slice, on the profiler's clock, from the program's collector
(utils/observe.py::PROFILED); None where the program has no such span."""


def read(ctx):
    from fmcw_radar_processing_tpu_torch.utils import observe

    collector = getattr(observe, "PROFILED", None)
    rec = collector.records.get("service.load") if collector is not None else None
    return 1e3 * rec.seconds / ctx["items"] if rec is not None else None
