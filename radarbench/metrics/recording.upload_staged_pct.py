"""The share of the recording's raw upload that crosses to the card through
the program's page-locked staging ring: 100 × the program's counter
``recording.upload_staged_bytes`` over its counter ``recording.upload_bytes``
(the raw's float32 bytes on the device), both summed over the traced slice,
from the program's collector (utils/observe.py::PROFILED), in %; None where
the program has no such counter."""


def read(ctx):
    from fmcw_radar_processing_tpu_torch.utils import observe

    collector = getattr(observe, "PROFILED", None)
    if collector is None:
        return None
    staged = collector.records.get("recording.upload_staged_bytes")
    uploaded = collector.records.get("recording.upload_bytes")
    if staged is None or uploaded is None or not uploaded.items:
        return None
    return 100.0 * (staged.items or 0) / uploaded.items
