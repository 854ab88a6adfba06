"""The program's span ``service.download``: both storage gets of the
request's recording (serve/handler.py::RadarService._download). Its host
seconds per call in the traced slice, on the profiler's clock, from the
program's collector (utils/observe.py::PROFILED); None where the program
has no such span."""


def read(ctx):
    from fmcw_radar_processing_tpu_torch.utils import observe

    collector = getattr(observe, "PROFILED", None)
    rec = collector.records.get("service.download") if collector is not None else None
    return 1e3 * rec.seconds / ctx["items"] if rec is not None else None
