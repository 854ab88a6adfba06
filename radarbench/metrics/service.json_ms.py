"""The program's span ``service.json``: every write_json of the request
(the four JSON artifacts, pretty-printed by the handler's default). Its
host seconds per call in the traced slice, on the profiler's clock, from
the program's collector (utils/observe.py::PROFILED); None where the
program has no such span."""


def read(ctx):
    from fmcw_radar_processing_tpu_torch.utils import observe

    collector = getattr(observe, "PROFILED", None)
    rec = collector.records.get("service.json") if collector is not None else None
    return 1e3 * rec.seconds / ctx["items"] if rec is not None else None
