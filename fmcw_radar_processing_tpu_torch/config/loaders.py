"""Config loaders: Infineon device XML → DeviceConfig.

Replaces the reference's xml2struct + field-path extraction
(radar_processing.m:94-115) with the stdlib ElementTree. The XML schema is
the Infineon radar export format: nested endpoints under a ``Device`` root.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

from fmcw_radar_processing_tpu_torch.config.radar import DeviceConfig


def _text(root: ET.Element, path: str) -> str:
    node = root.find(path)
    if node is None or node.text is None:
        raise ValueError(f"radar XML missing required field: {path}")
    return node.text.strip()


def device_config_from_xml(xml_text: str) -> DeviceConfig:
    """Parse an Infineon device XML string into a DeviceConfig.

    Field paths mirror radar_processing.m:94-115
    (sXML.Device.BaseEndpoint.chirpDuration_ns etc.). The root element may
    be ``Device`` itself or a wrapper containing it.
    """
    root = ET.fromstring(xml_text)
    dev = root if root.tag == "Device" else root.find("Device")
    if dev is None:
        raise ValueError("radar XML has no <Device> element")
    return DeviceConfig(
        chirp_duration_ns=float(_text(dev, "BaseEndpoint/chirpDuration_ns")),
        lower_frequency_khz=float(
            _text(dev, "FmcwEndpoint/FmcwConfiguration/lowerFrequency_kHz")
        ),
        upper_frequency_khz=float(
            _text(dev, "FmcwEndpoint/FmcwConfiguration/upperFrequency_kHz")
        ),
        num_tx_antennas=int(_text(dev, "BaseEndpoint/DeviceInfo/numAntennasTx")),
        num_rx_antennas=int(_text(dev, "BaseEndpoint/DeviceInfo/numAntennasRx")),
        num_samples_per_chirp=int(
            _text(dev, "BaseEndpoint/FrameFormat/numSamplesPerChirp")
        ),
        num_chirps_per_frame=int(
            _text(dev, "BaseEndpoint/FrameFormat/numChirpsPerFrame")
        ),
        samplerate_hz=float(
            _text(dev, "AdcxmcEndpoint/AdcxmcConfiguration/samplerateHz")
        ),
    )


def device_config_from_xml_file(path: str) -> DeviceConfig:
    with open(path, "r", encoding="utf-8") as f:
        return device_config_from_xml(f.read())


def device_config_to_xml(cfg: DeviceConfig) -> str:
    """Serialize a DeviceConfig back to the Infineon XML schema.

    Used by the synthetic-recording writer so round-trip tests can exercise
    the same parse path the service uses on real device exports.
    """

    def fmt(x: float) -> str:
        return repr(int(x)) if float(x).is_integer() else repr(float(x))

    return f"""<?xml version="1.0" encoding="UTF-8"?>
<Device>
  <BaseEndpoint>
    <chirpDuration_ns>{fmt(cfg.chirp_duration_ns)}</chirpDuration_ns>
    <DeviceInfo>
      <numAntennasTx>{cfg.num_tx_antennas}</numAntennasTx>
      <numAntennasRx>{cfg.num_rx_antennas}</numAntennasRx>
    </DeviceInfo>
    <FrameFormat>
      <numSamplesPerChirp>{cfg.num_samples_per_chirp}</numSamplesPerChirp>
      <numChirpsPerFrame>{cfg.num_chirps_per_frame}</numChirpsPerFrame>
    </FrameFormat>
  </BaseEndpoint>
  <FmcwEndpoint>
    <FmcwConfiguration>
      <lowerFrequency_kHz>{fmt(cfg.lower_frequency_khz)}</lowerFrequency_kHz>
      <upperFrequency_kHz>{fmt(cfg.upper_frequency_khz)}</upperFrequency_kHz>
    </FmcwConfiguration>
  </FmcwEndpoint>
  <AdcxmcEndpoint>
    <AdcxmcConfiguration>
      <samplerateHz>{fmt(cfg.samplerate_hz)}</samplerateHz>
    </AdcxmcConfiguration>
  </AdcxmcEndpoint>
</Device>
"""
