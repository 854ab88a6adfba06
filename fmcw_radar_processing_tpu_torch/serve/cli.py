"""Command-line interface of the PyTorch pipeline.

    python -m fmcw_radar_processing_tpu_torch.serve.cli synth <base> --frames N
    python -m fmcw_radar_processing_tpu_torch.serve.cli process <base> [--algo production] [--activity]
    python -m fmcw_radar_processing_tpu_torch.serve.cli serve-once [--profile production] [--activity]

``--device`` (default ``cuda``) picks where the pipeline runs; ``cpu`` runs
the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def cmd_process(args) -> int:
    from fmcw_radar_processing_tpu.config import AlgorithmConfig, RadarConfig
    from fmcw_radar_processing_tpu.utils.jsonio import write_json
    from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline
    from fmcw_radar_processing_tpu_torch.pipeline.spectrogram_image import (
        render_spectrogram_png,
    )
    from fmcw_radar_processing_tpu_torch.serve.handler import load_recording
    from fmcw_radar_processing_tpu_torch.utils.observe import NullTimer, StageTimer

    timer = StageTimer() if args.profile else None
    raw, calib, device = load_recording(args.base)
    algo = (AlgorithmConfig.production() if args.algo == "production"
            else AlgorithmConfig())
    cfg = RadarConfig.create(device, algo)
    name = os.path.basename(args.base)
    pipe = RadarPipeline(cfg, filename=name, device=args.device)
    outdir = args.output_dir or "."
    os.makedirs(outdir, exist_ok=True)
    if args.activity:
        # One stage, as the JAX CLI times activity mode.
        with (timer or NullTimer()).stage("activity_batches",
                                          items=raw.shape[0]):
            batches = pipe.process_activity(raw, calib)
        for b in batches:
            write_json(os.path.join(outdir, b.filename), b.payload,
                       pretty=not args.compact_json)
            print(f"wrote {b.filename}")
    else:
        out = pipe.process_recording(raw, calib, timer=timer)
        for fname, payload in out.payloads.items():
            write_json(os.path.join(outdir, fname), payload,
                       pretty=not args.compact_json)
            print(f"wrote {fname}")
        png = os.path.join(outdir, "spectrogram.png")
        # Linear-frequency PSD — what surf(T, F, psd) renders
        # (radar_processing.m:331-340); the JSONs carry the log grid.
        render_spectrogram_png(png, out.spectrogram_times,
                               out.spectrogram_linear_freqs,
                               out.spectrogram_psd_db)
        print(f"wrote {png}")
    if timer is not None:
        print(timer.pretty())
    return 0


def cmd_synth(args) -> int:
    from fmcw_radar_processing_tpu.config import RadarConfig, default_device_config
    from fmcw_radar_processing_tpu.io.raw_format import write_recording
    from fmcw_radar_processing_tpu.io.synth import (
        SyntheticTarget,
        synthesize_recording,
    )

    cfg = RadarConfig.create(default_device_config())
    targets = []
    for spec in args.target or ["7.5:3", "16.9:-2"]:
        parts = spec.split(":")
        targets.append(
            SyntheticTarget(
                range_m=float(parts[0]),
                doppler_bin_offset=int(parts[1]) if len(parts) > 1 else 0,
                amplitude=float(parts[2]) if len(parts) > 2 else 4.0,
            )
        )
    rec = synthesize_recording(cfg, args.frames, tuple(targets), seed=args.seed)
    xml, bin_ = write_recording(args.base, rec)
    print(f"wrote {xml} and {bin_} ({args.frames} frames)")
    return 0


def cmd_serve_once(args) -> int:
    from fmcw_radar_processing_tpu_torch.serve.handler import HandlerConfig, main

    cfg = HandlerConfig(
        fdata=args.fdata,
        workdir=args.workdir,
        storage_spec=args.storage,
        upload=not args.no_upload,
        profile=args.profile,
        device=args.device,
    )
    request = {"processAnimalActivity": "yes" if args.activity else "no"}
    result = main(request, cfg)
    print(json.dumps(result, indent=2))
    return 0 if result["status"] == "success" else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fmcw-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    profile_help = ("fidelity = reference-literal STFT/f32 artifacts; "
                    "production = AlgorithmConfig.production()")
    device_help = "torch device of the pipeline (cuda, or cpu for the plain versions)"
    activity_help = ("activity mode: one spectrogram JSON per batch of "
                     "frames (processAnimalActivity 'yes')")

    pp = sub.add_parser("process", help="run the signal chain on a recording")
    pp.add_argument("base", help="recording base path (<base>.xml + <base>.raw.bin)")
    pp.add_argument("--activity", action="store_true", help=activity_help)
    pp.add_argument("--output-dir")
    pp.add_argument("--algo", choices=["fidelity", "production"],
                    default="fidelity", help=profile_help)
    pp.add_argument("--device", default="cuda", help=device_help)
    pp.add_argument("--profile", action="store_true",
                    help="print per-stage timings and throughput")
    pp.add_argument("--compact-json", action="store_true",
                    help="write compact (non-pretty) JSON payloads — smaller and much faster")
    pp.set_defaults(fn=cmd_process)

    ps = sub.add_parser("synth", help="generate a synthetic recording")
    ps.add_argument("base")
    ps.add_argument("--frames", type=int, default=256)
    ps.add_argument("--target", action="append",
                    help="range_m:doppler_offset[:amplitude] (repeatable)")
    ps.add_argument("--seed", type=int, default=0)
    ps.set_defaults(fn=cmd_synth)

    po = sub.add_parser("serve-once", help="run the service handler once")
    po.add_argument("--fdata", default="radar_data")
    po.add_argument("--workdir", default=".")
    po.add_argument("--storage", default=None)
    po.add_argument("--activity", action="store_true", help=activity_help)
    po.add_argument("--no-upload", action="store_true")
    po.add_argument("--profile", choices=["fidelity", "production"],
                    default="fidelity", help=profile_help)
    po.add_argument("--device", default="cuda", help=device_help)
    po.set_defaults(fn=cmd_serve_once)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
