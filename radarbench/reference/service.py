"""What decides ``correct`` in the service cell: the artifacts that one
``POST /process`` 'no' request left in the blob storage, read back as the
dashboard and the classifier read them, held to the plain reference.

The caller reads the blobs (drivers/service.py::read_blobs): each JSON
artifact parsed with ``json``, the PNG decoded to RGB. The four JSON
artifacts, their lists taken as float64 arrays (``null`` as NaN), go to
:func:`compare.check_recording`, which gives
``detect_faults``, ``profile_err``, ``payload_faults`` and
``intensity_err``; the detections are the finite entries of the
range-speed artifact's ``range``. No artifact carries the dB map except
through the PNG, so ``db_err`` is left out. Beside them:

  response_faults  the step-status JSON and the storage against the
                   service's contract: a status other than "success"; a
                   step list other than Read Files, Radar Processing,
                   Upload JSON in that order, each successful; artifacts
                   other than the four JSON names and spectrogram.png; and
                   each of those five missing from the blob storage.
                   Exact, limit 0.
  image_err        the share of the PNG's pixels that differ by more than
                   2 levels in any channel from the reference's own
                   rendering (radar_processing.m:331-348): 1200×800 px,
                   the linear-frequency dB map kept to ≤ 150 Hz, clim
                   [−40, 0] dB, the jet colormap, nearest-neighbour
                   gridding, from the float64 reference dB map computed at
                   the 1,200 sampled columns only.

Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from radarbench.reference import compare
from radarbench.reference.chain import chain_blocked, derived

STEPS = ("Read Files", "Radar Processing", "Upload JSON")
PNG = "spectrogram.png"
IMAGE_SIZE = (1200, 800)  # 600 dpi export of a 600×400 pt figure (:332, :344)
FREQ_LIMIT_HZ = 150.0  # ylim [0 150] (:336)
CLIM_DB = (-40.0, 0.0)  # (:337)
LEVELS = 2  # pixel channels further apart than this differ


def json_names(filename: str) -> list[str]:
    """The four JSON artifacts of a 'no' request, in the order written."""
    return ["spectrogram_data.json", f"{filename}_range_fft_data.json",
            f"{filename}_range_speed_data.json", f"{filename}_fft_data.json"]


def artifact_names(filename: str) -> list[str]:
    return json_names(filename) + [PNG]


def _arrays(payload: dict) -> dict:
    """A parsed JSON artifact with its lists as float64 arrays (null as NaN)."""
    return {k: np.asarray(v, dtype=np.float64) if isinstance(v, list) else v
            for k, v in payload.items()}


def payload_arrays(blobs: dict, filename: str) -> dict:
    """The JSON artifacts among ``blobs``, by name, as arrays. The
    range-speed artifact's measurements are (targets, frames): JSON writes
    one target's as a flat list."""
    out = {n: _arrays(blobs[n]) for n in json_names(filename) if n in blobs}
    rs = out.get(f"{filename}_range_speed_data.json")
    if rs is not None:
        for key in ("range", "speed"):
            if isinstance(rs.get(key), np.ndarray):
                rs[key] = np.atleast_2d(rs[key])
    return out


def response_faults(response: dict, blobs: dict, filename: str) -> int:
    faults = int(response.get("status") != "success")
    steps = response.get("steps") or []
    faults += int([s.get("step") for s in steps] != list(STEPS))
    faults += sum(s.get("status") != "success" for s in steps)
    processing = [s for s in steps if s.get("step") == "Radar Processing"]
    artifacts = processing[0].get("artifacts") if processing else None
    faults += int(sorted(artifacts or []) != sorted(artifact_names(filename)))
    faults += sum(n not in blobs for n in artifact_names(filename))
    return faults


def jet(v: np.ndarray) -> np.ndarray:
    """MATLAB's jet colormap as the piecewise-linear function of a value in
    [0, 1] that jet(m) samples (dark blue, blue, cyan, yellow, red, dark
    red), as float RGB in [0, 1]."""
    v = np.clip(v, 0.0, 1.0)[..., None]
    centre = np.array([0.75, 0.5, 0.25])  # where red, green, blue peak
    return np.clip(1.5 - 4.0 * np.abs(v - centre), 0.0, 1.0)


def reference_image(raw: np.ndarray, calib: np.ndarray, cfg: dict, on,
                    block: int = 65536) -> np.ndarray:
    """The reference's rendering of a recording's spectrogram: uint8
    [800, 1200, 3].

    Pixel column x shows STFT column ⌊x·n/1200⌋ of the n valid columns;
    pixel row r (row 0 at the top) the first frequency bin at or above the
    row's centre frequency, f_hi − (r + ½)·(f_hi − f_lo)/800, over the bins
    at or below 150 Hz, f_lo their lowest and f_hi the larger of their
    highest and 150 Hz. A bin's frequency is k·(fs/nfft) in float32, as the
    artifacts state their axes, so that a row centre that falls exactly on
    a bin (at nfft 16,384, row 487 on bin 768) takes that bin."""
    dev, alg = cfg["device"], cfg["algorithm"]
    w, h = IMAGE_SIZE
    mag = chain_blocked(raw, calib, dev, alg, on).rows
    stft = compare._stft(alg, 1.0 / derived(dev, alg).prt, mag.shape[0], on)
    n = stft.columns(mag.shape[0])
    if n == 0:
        return np.zeros((h, w, 3), np.uint8)
    cols = np.minimum(np.arange(w) * n // w, n - 1)
    idx = torch.as_tensor(cols, device=on)[:, None] + torch.arange(stft.window, device=on)
    s = torch.fft.rfft(mag[idx] * stft.w, n=stft.nfft, dim=1)
    db = stft.db((s.real ** 2 + s.imag ** 2).T * stft.gain, stft.gmax(mag, block))
    freqs = (np.arange(stft.nb, dtype=np.float32)
             * np.float32(stft.fs / stft.nfft)).astype(np.float64)
    keep = np.flatnonzero(freqs <= FREQ_LIMIT_HZ)
    freqs = freqs[keep]
    f_lo, f_hi = freqs.min(), max(freqs.max(), FREQ_LIMIT_HZ)
    centre = f_hi - (np.arange(h) + 0.5) * (f_hi - f_lo) / h
    rows = keep[np.minimum(np.searchsorted(freqs, centre), len(keep) - 1)]
    grid = db[torch.as_tensor(rows, device=on)].cpu().numpy()  # [h, w]
    lo, hi = CLIM_DB
    return np.floor(jet((np.clip(grid, lo, hi) - lo) / (hi - lo)) * 255.0 + 0.5
                    ).astype(np.uint8)


def image_err(got, want: np.ndarray) -> float:
    """Share of the decoded PNG's pixels more than LEVELS from ``want`` in
    any channel; 1 where there is no image or one of another size."""
    got = np.asarray(got if got is not None else np.zeros(0, np.uint8))
    if got.shape != want.shape:
        return 1.0
    gap = np.abs(got.astype(np.int16) - want.astype(np.int16)).max(axis=-1)
    return float(np.mean(gap > LEVELS))


def check_service(blobs: dict, response: dict, raw: np.ndarray, calib: np.ndarray,
                  cfg: dict, on, filename: str = "radar_data") -> dict:
    """The numbers compared for one request. blobs: the artifacts found in
    the blob storage by name, each JSON one parsed, the PNG as uint8 RGB
    [800, 1200, 3]; raw [F, PN, 2·NTS] and calib [NTS, 2]: the first
    antenna's chirps and calibration that the recording was written from."""
    payloads = payload_arrays(blobs, filename)
    rs = payloads.get(f"{filename}_range_speed_data.json", {})
    rng = rs.get("range", np.zeros((1, 0)))
    out = {"payloads": payloads, "detected": np.isfinite(rng[0]),
           "strength": None, "db": None}
    readings = compare.check_recording(out, raw, calib, cfg, on, filename)
    del readings["db_err"]
    readings["response_faults"] = response_faults(response, blobs, filename)
    readings["image_err"] = image_err(blobs.get(PNG), reference_image(raw, calib, cfg, on))
    return readings
