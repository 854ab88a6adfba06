"""What decides ``correct``: the program's outputs held to the plain
reference, number by number.

Every function takes the program's outputs as host NumPy (what the timed
path handed back) and the inputs the benchmark made, recomputes the
reference on the torch device ``on`` in float64, and returns the numbers
compared, by name:

  detect_faults   frames whose detection, range bin or Doppler bin differ
                  from the reference's (and, for the stream, channels
                  whose valid column count differs); exact, limit 0.
  payload_faults  schema keys, titles, labels, shapes, frame indices and
                  axes (time, frequency, range) that disagree with the
                  reference's, axes by more than 4 float32 ulps; exact,
                  limit 0.
  profile_err     the widest gap of the range profile (waterfall, target
                  strength, the fft snapshot) over the reference's
                  largest profile value.
  db_err          the widest gap of the dB map over every valid column, in
                  the linear domain: max |10^(dB/20) − 10^(dB_ref/20)|,
                  which weighs each dB value by the share of the maximum
                  it stands for (a gap at the −1000 dB floor weighs
                  nothing, one at 0 dB the most).
  intensity_err   the same for the log-frequency intensity.

Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from radarbench.reference.chain import Derived, chain, chain_blocked, derived, packed_magnitude
from radarbench.reference.export import StftRef

EPS32 = float(np.finfo(np.float32).eps)
SPECTROGRAM = {"title": "All Frames - Log-Scaled Spectrogram",
               "xLabel": "Time (s)", "yLabel": "Frequency (Hz)"}
BATCH_LABELS = {"xLabel": "Time (s) (relative to detected activity)",
                "yLabel": "Frequency (Hz)"}
SNAPSHOT_FRAME = 100  # the fft snapshot's 1-based frame (radar_processing.m:411)


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def axis_faults(got, want) -> int:
    """Entries of ``got`` more than 4 float32 ulps from ``want`` (all of
    them when the shapes differ)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return max(got.size, want.size, 1)
    tol = 4 * EPS32 * np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    return int(np.sum(~(np.abs(got - want) <= tol)))


def _fields(payload: dict, want: dict) -> int:
    """Fields of ``want`` that ``payload`` lacks or holds otherwise."""
    return sum(payload.get(k) != v for k, v in want.items())


def _keys(payload: dict, keys) -> int:
    return int(set(payload) != set(keys))


def lin_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |10^(got/20) − 10^(ref/20)| of two dB blocks (0 when empty)."""
    if got.numel() == 0:
        return 0.0
    g = torch.pow(10.0, got.to(torch.float64) / 20.0)
    return float((g - torch.pow(10.0, ref / 20.0)).abs().max())


def _cols(a: np.ndarray, s: int, e: int, on) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a[:, s:e]), device=on)


def detection_faults(rng, spd, det, ref, d: Derived) -> int:
    """Frames whose detection flag, range bin or Doppler offset differ from
    the reference's. rng/spd: [F] float (NaN where undetected); det: [F]."""
    rng, spd = np.asarray(rng, np.float64), np.asarray(spd, np.float64)
    det = np.asarray(det, bool)
    r_det = ref.detected.cpu().numpy()
    if not rng.shape == spd.shape == det.shape == r_det.shape:
        return max(r_det.size, 1)
    r_bin = ref.range_bin.cpu().numpy()
    r_off = ref.doppler_offset.cpu().numpy()
    with np.errstate(invalid="ignore"):
        g_bin = np.rint(rng / d.dist_per_bin)
        g_off = np.rint(spd / d.speed_step)
    bad = det != r_det
    bad |= r_det & ((g_bin != r_bin) | (g_off != r_off))
    bad |= ~r_det & ~(np.isnan(rng) & np.isnan(spd))
    return int(bad.sum())


def _profile_gap(waterfall_kf, strength, snapshot, frame_index, ref) -> float:
    """profile_err: waterfall (K, F), strength [F] and the snapshot's
    magnitude [K] of frame ``frame_index`` (1-based) against the reference
    profile, over its largest value."""
    prof = ref.profile
    scale = float(prof.abs().max())
    wf = torch.as_tensor(np.asarray(waterfall_kf), device=prof.device)
    if tuple(wf.shape) != tuple(prof.T.shape):
        return float("inf")
    gap = float((wf.to(torch.float64).T - prof).abs().max())
    det = ref.detected
    if strength is not None and bool(det.any()):
        s = torch.as_tensor(np.asarray(strength, np.float64), device=prof.device)
        if s.shape != det.shape:
            return float("inf")
        gap = max(gap, float((s[det] - ref.strength[det]).abs().max()))
    if snapshot is not None:
        m = torch.as_tensor(np.asarray(snapshot, np.float64), device=prof.device)
        gap = max(gap, float((m - prof[frame_index - 1]).abs().max()))
    return gap / scale


def _stft(alg: dict, fs: float, count: int, on, nfft: int | None = None) -> StftRef:
    """The reference STFT of a ``count``-sample signal: nfft as the
    configuration pins it, else 2^nextpow2(count) (radar_processing.m:273)."""
    return StftRef(alg["stft_window_length"], alg["stft_kaiser_beta"],
                   nfft or alg["stft_nfft"] or next_pow2(count), fs,
                   alg["max_freq_bins"], on)


def _export_gaps(mag: torch.Tensor, db, intensity, stft: StftRef,
                 block: int) -> tuple[int, float, float]:
    """(shape faults, db_err, intensity_err) of one packed signal's export
    against the program's dB map [nb, n] (or None) and intensity [bins, n]."""
    on = mag.device
    n = stft.columns(int(mag.shape[0]))
    faults = int(np.shape(intensity) != (stft.num_bins, n))
    if db is not None:
        faults += int(np.shape(db) != (stft.nb, n))
    if faults:
        return faults, float("inf"), float("inf")
    g = stft.gmax(mag, block)
    db_err = ie = 0.0
    for s in range(0, n, block):
        e = min(s + block, n)
        ref_db = stft.db(stft.power(mag, s, e), g)
        if db is not None:
            db_err = max(db_err, lin_gap(_cols(db, s, e, on), ref_db))
        ie = max(ie, lin_gap(_cols(intensity, s, e, on), stft.rescale(ref_db)))
    return 0, db_err, ie


def _spectrogram_payload_faults(p: dict, stft_axes, n: int) -> int:
    times, log_freqs = stft_axes
    return (_keys(p, ("time", "frequency", "intensity", *SPECTROGRAM))
            + _fields(p, SPECTROGRAM) + axis_faults(p.get("time"), times(n))
            + axis_faults(p.get("frequency"), log_freqs()))


def check_recording(out: dict, raw: np.ndarray, calib: np.ndarray, cfg: dict,
                    on, filename: str = "radar_data", block: int = 65536,
                    sharded: bool = False) -> dict:
    """The recording ('no') outputs held to the reference.

    out: "payloads" (the payload dicts by file name), "detected" [F] and
    "db" [nb, n]; with RadarPipeline's four payloads also "strength" [F],
    the waterfall, ranges and speeds being read from the payloads, as users
    get them. ``sharded``: ShardedRecordingPipeline's outputs, the
    spectrogram payload only, with "waterfall" (K, F), "range" and "speed"
    [F] beside it."""
    dev, alg = cfg["device"], cfg["algorithm"]
    d = derived(dev, alg)
    ref = chain_blocked(raw, calib, dev, alg, on)
    pay = out["payloads"]
    names = {"spec": "spectrogram_data.json",
             "rfft": f"{filename}_range_fft_data.json",
             "rs": f"{filename}_range_speed_data.json",
             "fft": f"{filename}_fft_data.json"}
    f = raw.shape[0]
    k = alg["range_fft_size"]
    frame = min(max(SNAPSHOT_FRAME, 1), f)
    if sharded:
        faults = int(set(pay) != {names["spec"]})
        waterfall, strength, snapshot = out["waterfall"], None, None
        rng, spd = out["range"], out["speed"]
    else:
        faults = int(set(pay) != set(names.values()))
        rfft, rs, fft = (pay.get(names[x], {}) for x in ("rfft", "rs", "fft"))
        frames = np.arange(f) * alg["frame_time"]
        faults += (_keys(rfft, ("time_axis", "array_bin_range", "range_tx1rx1_max_abs",
                                "filename"))
                   + _fields(rfft, {"filename": filename})
                   + axis_faults(rfft.get("time_axis"), frames)
                   + axis_faults(rfft.get("array_bin_range"), np.arange(k) * d.dist_per_bin))
        faults += (_keys(rs, ("time_axis", "range", "speed", "filename"))
                   + _fields(rs, {"filename": filename})
                   + axis_faults(rs.get("time_axis"), frames))
        faults += (_keys(fft, ("range_bins", "magnitude", "frame_index", "filename"))
                   + _fields(fft, {"filename": filename, "frame_index": frame})
                   + axis_faults(fft.get("range_bins"), np.arange(k)))
        waterfall, strength, snapshot = (rfft.get("range_tx1rx1_max_abs"), out["strength"],
                                         fft.get("magnitude"))
        rng, spd = (np.asarray(rs.get(x, np.zeros((1, 0))), np.float64)[0]
                    for x in ("range", "speed"))
    readings = {"detect_faults": detection_faults(rng, spd, out["detected"], ref, d),
                "profile_err": _profile_gap(waterfall, strength, snapshot, frame, ref)}
    mag = ref.rows
    spec = pay.get(names["spec"], {})
    stft = _stft(alg, 1.0 / d.prt, mag.shape[0], on)
    shape_faults, db_err, ie = _export_gaps(mag, out["db"], spec.get("intensity"),
                                            stft, block)
    faults += shape_faults + _spectrogram_payload_faults(
        spec, (stft.times, stft.log_freqs), stft.columns(mag.shape[0]))
    readings.update(payload_faults=faults, db_err=db_err, intensity_err=ie)
    return readings


def check_activity(batches: list, raw: np.ndarray, calib: np.ndarray, cfg: dict,
                   on, filename: str = "radar_data") -> dict:
    """The activity ('yes') outputs held to the reference: the batches of
    ``batch_size`` frames in order, each with at least one STFT window of
    packed samples, up to ``max_plots`` of them.

    batches: dicts with "batch", "start_frame", "end_frame", "filename" and
    "payload"."""
    dev, alg = cfg["device"], cfg["algorithm"]
    d = derived(dev, alg)
    f, bs, w = raw.shape[0], alg["batch_size"], alg["stft_window_length"]
    cal = torch.as_tensor(calib, device=on)
    want = []
    for b in range(-(-f // bs)):
        if len(want) >= alg["max_plots"]:
            break
        s, e = b * bs, min((b + 1) * bs, f)
        r = chain(torch.as_tensor(raw[s:e], device=on), cal, dev, alg)
        mag = packed_magnitude(r.rows, r.detected)
        if mag.shape[0] >= w:
            want.append((b + 1, s + 1, e, mag))
    faults = abs(len(batches) - len(want))
    ie = 0.0
    for got, (b, s, e, mag) in zip(batches, want):
        p = got.get("payload", {})
        meta = {"batch": b, "start_frame": s, "end_frame": e,
                "filename": f"{filename}_spectrogram_batch_{b}.json"}
        faults += _fields(got, meta)
        faults += (_keys(p, ("time", "frequency", "intensity", "title", *BATCH_LABELS,
                             "start_frame", "end_frame", "filename_base"))
                   + _fields(p, {"title": f"Spectrogram - Batch {b}", **BATCH_LABELS,
                                 "start_frame": s, "end_frame": e,
                                 "filename_base": filename}))
        stft = _stft(alg, 1.0 / d.prt, mag.shape[0], on)
        faults += axis_faults(p.get("time"), stft.times(stft.columns(mag.shape[0])))
        faults += axis_faults(p.get("frequency"), stft.log_freqs())
        sf, _, gap = _export_gaps(mag, None, p.get("intensity"), stft, 1 << 16)
        faults += sf
        ie = max(ie, gap)
    return {"payload_faults": faults, "intensity_err": ie}


def check_stream_windows(kept: dict, pool_raw: np.ndarray, calib: np.ndarray,
                         cfg: dict, on) -> dict:
    """Streamed windows held to the reference stream.

    kept: {window number: outputs} of windows fed in order from the pool
    (window i is pool window i mod P), outputs as host NumPy: waterfall
    [C, F, K], range/speed [C, 1, F], detected [C, F], psd_db [C, nb, L]
    and col_count [C]. pool_raw: [C, P, F, PN, 2·NTS]; calib [C, NTS, 2].
    Each window's columns are those of the channel's stream that start in
    it or in the carried last W−1 samples of the window before; per_window
    dB normalizes them by the window's own maximum."""
    dev, alg = cfg["device"], cfg["algorithm"]
    if cfg.get("db_mode", "per_window") != "per_window":
        raise ValueError("the reference stream is per_window")
    d = derived(dev, alg)
    c, pool = pool_raw.shape[:2]
    w = alg["stft_window_length"]
    stft = _stft(alg, 1.0 / d.prt, 0, on, nfft=cfg["nfft"])
    cache: dict = {}

    def pooled(ch, j):
        if (ch, j) not in cache:
            r = chain(torch.as_tensor(pool_raw[ch, j], device=on),
                      torch.as_tensor(calib[ch], device=on), dev, alg)
            cache[(ch, j)] = (r, packed_magnitude(r.rows, r.detected))
        return cache[(ch, j)]

    det_faults, prof, db_err = 0, 0.0, 0.0
    for i, out in sorted(kept.items()):
        for ch in range(c):
            r, mag = pooled(ch, i % pool)
            if i > 0:
                mag = torch.cat([pooled(ch, (i - 1) % pool)[1][-(w - 1):], mag])
            det_faults += detection_faults(out["range"][ch, 0], out["speed"][ch, 0],
                                           out["detected"][ch], r, d)
            prof = max(prof, _profile_gap(out["waterfall"][ch].T,
                                          out["strength"][ch, 0], None, 0, r))
            n = stft.columns(mag.shape[0])
            if int(out["col_count"][ch]) != n:
                det_faults += 1
                continue
            if n == 0:
                continue
            p = stft.power(mag, 0, n)
            ref_db = stft.db(p, p.amax())
            got = torch.as_tensor(np.ascontiguousarray(out["psd_db"][ch][:, :n]), device=on)
            db_err = max(db_err, lin_gap(got, ref_db))
    return {"detect_faults": det_faults, "profile_err": prof, "db_err": db_err}
