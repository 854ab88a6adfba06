"""Command-line interface of the PyTorch pipeline.

    python -m fmcw_radar_processing_tpu_torch.serve.cli synth <base> --frames N
    python -m fmcw_radar_processing_tpu_torch.serve.cli process <base> [--algo production] [--activity]
    python -m fmcw_radar_processing_tpu_torch.serve.cli serve-once [--profile production] [--activity]
    python -m fmcw_radar_processing_tpu_torch.serve.cli serve [--port 8060] [--classifier-artifact DIR]
    python -m fmcw_radar_processing_tpu_torch.serve.cli dashboard <data_dir> [--port 8050]
    python -m fmcw_radar_processing_tpu_torch.serve.cli classify --artifact DIR <image> ...
    python -m fmcw_radar_processing_tpu_torch.serve.cli config <xml>

``--device`` (default ``cuda``) picks where the pipeline and the classifier
run; ``cpu`` runs the plain PyTorch versions of the kernels.
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


def cmd_classify(args) -> int:
    from fmcw_radar_processing_tpu_torch.models.infer import SpectrogramClassifier

    try:
        clf = SpectrogramClassifier.load(args.artifact, args.device)
    except FileNotFoundError as e:
        print(str(e), file=sys.stderr)
        return 1
    results = clf.classify_files(args.images)
    print(json.dumps({"classes": list(clf.classes),
                      "predictions": results}, indent=2))
    return 0


def cmd_config(args) -> int:
    from fmcw_radar_processing_tpu.config import (
        RadarConfig,
        device_config_from_xml_file,
    )

    cfg = RadarConfig.create(device_config_from_xml_file(args.xml))
    print(cfg.to_json())
    return 0


def cmd_serve(args) -> int:
    from fmcw_radar_processing_tpu_torch.serve.handler import HandlerConfig
    from fmcw_radar_processing_tpu_torch.serve.http_service import RadarHttpService

    cfg = HandlerConfig(
        fdata=args.fdata,
        workdir=args.workdir,
        storage_spec=args.storage,
        upload=not args.no_upload,
        profile=args.profile,
        device=args.device,
    )
    try:
        srv = RadarHttpService(cfg, port=args.port, host=args.host,
                               classifier_artifact=args.classifier_artifact,
                               classify_queue_images=args.classify_queue)
    except FileNotFoundError as e:  # before OSError, its base class
        print(str(e), file=sys.stderr)
        return 1
    except OSError as e:
        print(f"cannot bind {args.host}:{args.port}: {e.strerror or e}",
              file=sys.stderr)
        return 1
    eps = "POST /process" + (", POST /classify" if srv.classifier else "")
    print(f"radar service on {srv.url} ({eps}) — Ctrl-C to stop")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return 0


def cmd_dashboard(args) -> int:
    from fmcw_radar_processing_tpu_torch.serve.dashboard import DashboardServer

    try:
        srv = DashboardServer(args.data_dir, port=args.port, host=args.host)
    except OSError as e:
        print(f"cannot bind {args.host}:{args.port}: {e.strerror or e}",
              file=sys.stderr)
        return 1
    print(f"dashboard on {srv.url} (data: {args.data_dir}) — Ctrl-C to stop")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.httpd.server_close()
    return 0


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

    pcl = sub.add_parser("classify",
                         help="classify spectrogram images with an artifact")
    pcl.add_argument("--artifact", required=True,
                     help="inference artifact dir (params.npz + meta.json)")
    pcl.add_argument("--device", default="cuda", help=device_help)
    pcl.add_argument("images", nargs="+", help="image files to classify")
    pcl.set_defaults(fn=cmd_classify)

    pv = sub.add_parser("serve", help="run the persistent HTTP service (MPS equivalent)")
    pv.add_argument("--fdata", default="radar_data")
    pv.add_argument("--workdir", default=".")
    pv.add_argument("--storage", default=None)
    pv.add_argument("--no-upload", action="store_true")
    pv.add_argument("--port", type=int, default=8060)
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--classifier-artifact",
                    help="also serve POST /classify from this artifact dir")
    pv.add_argument("--profile", choices=["fidelity", "production"],
                    default="fidelity", help=profile_help)
    pv.add_argument("--classify-queue", type=int, default=256,
                    help="bounded /classify queue (images); full queue "
                         "answers 503 (backpressure)")
    pv.add_argument("--device", default="cuda", help=device_help)
    pv.set_defaults(fn=cmd_serve)

    pd = sub.add_parser("dashboard", help="serve the monitoring dashboard")
    pd.add_argument("data_dir", help="directory with the pipeline's payloads")
    pd.add_argument("--port", type=int, default=8050)
    pd.add_argument("--host", default="127.0.0.1")
    pd.set_defaults(fn=cmd_dashboard)

    pc = sub.add_parser("config", help="print derived configuration as JSON")
    pc.add_argument("xml")
    pc.set_defaults(fn=cmd_config)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
