from fmcw_radar_processing_tpu_torch.config.radar import (  # noqa: F401
    AlgorithmConfig,
    DerivedParams,
    DeviceConfig,
    RadarConfig,
    default_device_config,
    next_pow2,
)
from fmcw_radar_processing_tpu_torch.config.loaders import (  # noqa: F401
    device_config_from_xml,
    device_config_from_xml_file,
)
