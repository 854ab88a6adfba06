"""Raw IQ recording container — the framework's ``f_parse_data2`` equivalent.

The reference parses recordings through an external Infineon library
(``f_parse_data2`` + ``xml2struct``, called at radar_processing.m:86) that
is NOT in its repo (SURVEY §1 L2); only the parser's *outputs* are
specified by the call sites:

    frame(i).Chirp : (NTS, PN, numRx) complex IQ samples  (:199,202)
    calib_data     : length 2·numRx·N_cal ADC calibration  (:167-174)
    sXML           : device configuration                   (:94-115)

This module defines a self-describing binary container carrying exactly
that logical content, laid out for zero-copy NumPy consumption:

    header  : magic 'FMCWTPU0' (8 bytes), uint32 version, uint32 frame_count,
              uint32 num_rx, uint32 n_cal, uint32 pn, uint32 nts,
              uint32 flags (bit0: complex IQ; 0 ⇒ real-only samples)
    calib   : per rx antenna, N_cal float32 I then N_cal float32 Q
              (the reference's calib_data layout, radar_processing.m:171-172)
    frames  : float32, index order [frame][rx][chirp][sample][iq] —
              chirps-then-samples-innermost so a single ``view(complex64)``
              + ``reshape`` yields the chain's layout [F, R, PN, NTS] with
              no transposes or copies.

A recording on disk is the XML config (io/loaders schema) next to the
``.raw.bin`` file, mirroring the reference's two-file convention
(radar_data.xml + radar_data.raw.bin, read_data_from_blob_storage.m:18).

The port's own copy of the JAX package's ``io/raw_format.py``: the same
container, byte for byte. :func:`load_recording_for_chain` reads through
the native streaming loader (io/native_loader.py) when it builds, and
with NumPy otherwise.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from fmcw_radar_processing_tpu_torch.config import (
    DeviceConfig,
    device_config_from_xml,
)
from fmcw_radar_processing_tpu_torch.config.loaders import device_config_to_xml
from fmcw_radar_processing_tpu_torch.utils.cplx import to_pair

MAGIC = b"FMCWTPU0"
VERSION = 1
_HEADER = struct.Struct("<8sIIIIIII")


@dataclasses.dataclass
class RawRecording:
    """Parsed recording.

    frames: [F, R, PN, NTS] complex64 (or float32 when real-only)
    calib:  [R, 2, N_cal] float32 — raw I/Q calibration blocks per antenna
    """

    frames: np.ndarray
    calib: np.ndarray
    device: DeviceConfig | None = None

    @property
    def frame_count(self) -> int:
        return self.frames.shape[0]

    def calib_vector(self, rx: int, nts: int) -> np.ndarray:
        """Decimated complex calibration vector (radar_processing.m:167-174):
        calib_rx = (I[::dec] + i·Q[::dec]) with dec = N_cal / NTS."""
        n_cal = self.calib.shape[-1]
        dec = n_cal // nts
        if dec * nts != n_cal:
            raise ValueError(f"N_cal={n_cal} not divisible by NTS={nts}")
        i = self.calib[rx, 0, ::dec]
        q = self.calib[rx, 1, ::dec]
        return (i + 1j * q).astype(np.complex64)

    def rx1(self) -> np.ndarray:
        """First-antenna frames in the chain's layout [F, PN, NTS]
        (matrix_raw_data(:,:,1), radar_processing.m:202)."""
        return self.frames[:, 0]

    def rx1_pair(self) -> np.ndarray:
        """rx1 frames in the pair layout [F, PN, NTS, 2] float32."""
        return to_pair(self.rx1())

    def calib_pair(self, rx: int, nts: int) -> np.ndarray:
        """Decimated calibration vector as a [NTS, 2] float32 pair."""
        return to_pair(self.calib_vector(rx, nts))


def write_raw_bin(path: str, rec: RawRecording) -> None:
    frames = rec.frames
    if frames.ndim != 4:
        raise ValueError("frames must be [F, R, PN, NTS]")
    f, r, pn, nts = frames.shape
    is_complex = np.iscomplexobj(frames)
    calib = np.ascontiguousarray(rec.calib, np.float32)
    if calib.shape[:2] != (r, 2):
        raise ValueError("calib must be [R, 2, N_cal]")
    n_cal = calib.shape[-1]
    with open(path, "wb") as fh:
        fh.write(
            _HEADER.pack(MAGIC, VERSION, f, r, n_cal, pn, nts,
                         1 if is_complex else 0)
        )
        fh.write(calib.tobytes())
        if is_complex:
            fh.write(np.ascontiguousarray(frames, np.complex64).tobytes())
        else:
            fh.write(np.ascontiguousarray(frames, np.float32).tobytes())


def read_raw_bin(path: str) -> RawRecording:
    with open(path, "rb") as fh:
        head = fh.read(_HEADER.size)
        magic, version, f, r, n_cal, pn, nts, flags = _HEADER.unpack(head)
        if magic != MAGIC:
            raise ValueError(f"{path}: not a FMCWTPU0 raw recording")
        if version != VERSION:
            raise ValueError(f"{path}: unsupported version {version}")
        calib = np.frombuffer(fh.read(r * 2 * n_cal * 4), np.float32).reshape(
            r, 2, n_cal
        )
        dtype = np.complex64 if flags & 1 else np.float32
        frames = np.frombuffer(fh.read(), dtype).reshape(f, r, pn, nts)
    return RawRecording(frames=frames, calib=calib)


def write_recording(basepath: str, rec: RawRecording) -> tuple[str, str]:
    """Write <base>.xml + <base>.raw.bin (the reference's file pair)."""
    if rec.device is None:
        raise ValueError("recording has no device config to serialize")
    xml_path = basepath + ".xml"
    bin_path = basepath + ".raw.bin"
    with open(xml_path, "w", encoding="utf-8") as fh:
        fh.write(device_config_to_xml(rec.device))
    write_raw_bin(bin_path, rec)
    return xml_path, bin_path


def load_recording_for_chain(basepath: str, rx: int = 0):
    """Load <base>.{xml,raw.bin} straight into the chain's input layout.

    Prefers the native C++ streaming reader (io/native_loader.py) and falls
    back to the NumPy reader. Returns (raw_pair [F, PN, NTS, 2] float32,
    calib_pair [NTS, 2] float32, DeviceConfig).
    """
    from fmcw_radar_processing_tpu_torch.io.native_loader import (
        NativeRecordingReader,
        native_available,
    )

    with open(basepath + ".xml", "r", encoding="utf-8") as fh:
        device = device_config_from_xml(fh.read())
    if native_available():
        r = NativeRecordingReader(basepath + ".raw.bin")
        if (r.pn, r.nts, r.num_rx) != (device.pn, device.nts,
                                       device.num_rx_antennas):
            raise ValueError(
                f"raw.bin header {(r.num_rx, r.pn, r.nts)} disagrees with "
                f"XML config {(device.num_rx_antennas, device.pn, device.nts)}")
        raw = r.read_frames(0, r.frame_count, rx=rx)
        calib = r.calib_vector_pair(rx=rx, nts=device.nts)
        return raw, calib, device
    rec = read_recording(basepath)
    return (to_pair(rec.frames[:, rx]),
            to_pair(rec.calib_vector(rx, device.nts)), device)


def read_recording(basepath: str) -> RawRecording:
    """Read <base>.xml + <base>.raw.bin → RawRecording with DeviceConfig."""
    with open(basepath + ".xml", "r", encoding="utf-8") as fh:
        device = device_config_from_xml(fh.read())
    rec = read_raw_bin(basepath + ".raw.bin")
    f, r, pn, nts = rec.frames.shape
    if (pn, nts) != (device.pn, device.nts) or r != device.num_rx_antennas:
        raise ValueError(
            f"raw.bin shape {(r, pn, nts)} disagrees with XML config "
            f"{(device.num_rx_antennas, device.pn, device.nts)}"
        )
    rec.device = device
    return rec
