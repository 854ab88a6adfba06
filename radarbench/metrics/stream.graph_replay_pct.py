"""The program's span ``stream.graph_replay``: opened once for each window
that process_window replays from its captured CUDA graphs. The share of
the traced slice's windows replayed, in %, from the program's collector
(utils/observe.py::PROFILED); None where the program has no such span."""


def read(ctx):
    from fmcw_radar_processing_tpu_torch.utils import observe

    collector = getattr(observe, "PROFILED", None)
    rec = collector.records.get("stream.graph_replay") if collector is not None else None
    return 100.0 * rec.count / ctx["items"] if rec is not None else None
