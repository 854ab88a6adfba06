"""The rate of the service's JSON writer: the program's counter
``service.json_bytes`` (the bytes of every JSON artifact written) over the
host seconds of its span ``service.json``, both summed over the traced
slice, from the program's collector (utils/observe.py::PROFILED), in GB/s;
None where the program has no such counter or span."""


def read(ctx):
    from fmcw_radar_processing_tpu_torch.utils import observe

    collector = getattr(observe, "PROFILED", None)
    if collector is None:
        return None
    nbytes = collector.records.get("service.json_bytes")
    write = collector.records.get("service.json")
    if nbytes is None or write is None or not nbytes.items or write.seconds <= 0:
        return None
    return nbytes.items / write.seconds / 1e9
