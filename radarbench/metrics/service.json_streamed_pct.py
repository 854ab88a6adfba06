"""The share of the service's JSON bytes that the native writer streamed
into the artifact files: 100 × the program's counter
``service.json_streamed_bytes`` over its counter ``service.json_bytes``
(the bytes of every JSON artifact written), both summed over the traced
slice, from the program's collector (utils/observe.py::PROFILED), in %;
None where the program has no such counter."""


def read(ctx):
    from fmcw_radar_processing_tpu_torch.utils import observe

    collector = getattr(observe, "PROFILED", None)
    if collector is None:
        return None
    streamed = collector.records.get("service.json_streamed_bytes")
    written = collector.records.get("service.json_bytes")
    if streamed is None or written is None or not written.items:
        return None
    return 100.0 * (streamed.items or 0) / written.items
