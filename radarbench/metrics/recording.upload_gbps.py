"""The rate of the recording's raw upload: the program's counter
``recording.upload_bytes`` (the raw's float32 bytes that cross to the card)
over the host seconds of its span ``recording.upload``, both summed over
the traced slice, from the program's collector (utils/observe.py::PROFILED),
in GB/s; None where the program has no such counter or span."""


def read(ctx):
    from fmcw_radar_processing_tpu_torch.utils import observe

    collector = getattr(observe, "PROFILED", None)
    if collector is None:
        return None
    nbytes = collector.records.get("recording.upload_bytes")
    upload = collector.records.get("recording.upload")
    if nbytes is None or upload is None or not nbytes.items or upload.seconds <= 0:
        return None
    return nbytes.items / upload.seconds / 1e9
