from fmcw_radar_processing_tpu_torch.io.raw_format import (  # noqa: F401
    RawRecording,
    read_raw_bin,
    read_recording,
    write_raw_bin,
    write_recording,
)
from fmcw_radar_processing_tpu_torch.io.synth import (  # noqa: F401
    SyntheticTarget,
    synthesize_recording,
)
from fmcw_radar_processing_tpu_torch.io.storage import (  # noqa: F401
    AzureBlobStorage,
    LocalStorage,
    Storage,
    get_storage,
)
