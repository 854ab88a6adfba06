"""Command-line interface of the PyTorch pipeline.

    python -m fmcw_radar_processing_tpu_torch.serve.cli synth <base> --frames N
    python -m fmcw_radar_processing_tpu_torch.serve.cli process <base> [--algo production] [--activity] [--trace-dir DIR]
    python -m fmcw_radar_processing_tpu_torch.serve.cli serve-once [--profile production] [--activity]
    python -m fmcw_radar_processing_tpu_torch.serve.cli serve [--port 8060] [--classifier-artifact DIR]
    python -m fmcw_radar_processing_tpu_torch.serve.cli dashboard <data_dir> [--port 8050]
    python -m fmcw_radar_processing_tpu_torch.serve.cli classify --artifact DIR <image> ...
    python -m fmcw_radar_processing_tpu_torch.serve.cli train --data-dir DIR [--export DIR]
    python -m fmcw_radar_processing_tpu_torch.serve.cli classifier-e2e --out-dir DIR
    python -m fmcw_radar_processing_tpu_torch.serve.cli robustness --out-dir DIR
    python -m fmcw_radar_processing_tpu_torch.serve.cli config <xml>

``--device`` (default ``cuda``) picks where the pipeline and the classifier
run, and where the classifier trains; ``cpu`` runs the plain PyTorch
versions of the kernels.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys


def cmd_process(args) -> int:
    from fmcw_radar_processing_tpu_torch.config import AlgorithmConfig, RadarConfig
    from fmcw_radar_processing_tpu_torch.utils.jsonio import write_json
    from fmcw_radar_processing_tpu_torch.pipeline.recording import RadarPipeline
    from fmcw_radar_processing_tpu_torch.pipeline.spectrogram_image import (
        render_spectrogram_png,
    )
    from fmcw_radar_processing_tpu_torch.serve.handler import load_recording
    from fmcw_radar_processing_tpu_torch.utils.observe import (
        PROFILED,
        NullTimer,
        StageTimer,
        trace,
    )

    timer = StageTimer() if args.profile else None
    if args.trace_dir:
        try:
            os.makedirs(args.trace_dir, exist_ok=True)
        except OSError as e:
            print(f"cannot create trace dir {args.trace_dir}: "
                  f"{e.strerror or e}", file=sys.stderr)
            return 1
        tracer = trace(args.trace_dir)
    else:
        tracer = contextlib.nullcontext()
    raw, calib, device = load_recording(args.base)
    algo = (AlgorithmConfig.production() if args.algo == "production"
            else AlgorithmConfig())
    cfg = RadarConfig.create(device, algo)
    name = os.path.basename(args.base)
    pipe = RadarPipeline(cfg, filename=name, device=args.device)
    outdir = args.output_dir or "."
    os.makedirs(outdir, exist_ok=True)
    with tracer:
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
    if args.trace_dir:
        print(f"profiler trace in {args.trace_dir}")
        print(PROFILED.pretty())  # the spans of the traced call, with counts
    return 0


def cmd_synth(args) -> int:
    from fmcw_radar_processing_tpu_torch.config import RadarConfig, default_device_config
    from fmcw_radar_processing_tpu_torch.io.raw_format import write_recording
    from fmcw_radar_processing_tpu_torch.io.synth import (
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


def cmd_train(args) -> int:
    from fmcw_radar_processing_tpu_torch.models.data import load_image_folder
    from fmcw_radar_processing_tpu_torch.models.train import TrainConfig, Trainer

    images, labels, classes = load_image_folder(args.data_dir)
    trainer = Trainer(
        args.model,
        TrainConfig(
            learning_rate=args.lr, epochs=args.epochs,
            batch_size=args.batch_size,
            freeze_backbone=args.freeze_backbone,
        ),
        input_shape=images.shape[1:],
        device=args.device,
    )
    if args.resume:
        try:
            trainer.load_state(args.resume)
        except FileNotFoundError as e:
            print(f"cannot resume: {e}", file=sys.stderr)
            return 1
        print(f"resumed from {args.resume} (step {trainer.step}, "
              f"{len(trainer.history)} epochs done)")
    trainer.fit(images, labels, log_fn=print)
    if args.checkpoint:
        trainer.save(args.checkpoint)
        print(f"saved checkpoint to {args.checkpoint}")
    if args.state_dir:
        trainer.save_state(args.state_dir)
        print(f"saved full train state to {args.state_dir}")
    names = tuple(classes) if len(classes) == 2 else ("0", "1")
    if args.export:
        from fmcw_radar_processing_tpu_torch.models.infer import export_classifier

        export_classifier(args.export, args.model, trainer.params,
                          images.shape[1:], names)
        print(f"exported inference artifact to {args.export}")
    loss, acc, _ = trainer.evaluate(images, labels)
    print(f"final train loss={loss:.4f} accuracy={acc:.4f} classes={classes}")
    print(json.dumps(trainer.classification_report(images, labels, names),
                     indent=2))
    return 0


def _class_specs(arg: str):
    """The ClassSpecs named in ``--classes``, or None (after a message) when
    fewer than two or an unknown name are given."""
    from fmcw_radar_processing_tpu_torch.models.dataset_gen import CLASS_SPECS

    names = [t.strip() for t in arg.split(",") if t.strip()]
    unknown = sorted(set(names) - set(CLASS_SPECS))
    if unknown or len(names) < 2:
        print(f"--classes: got {names!r}; need ≥2 comma-separated names "
              f"from {sorted(CLASS_SPECS)}"
              + (f" (unknown: {unknown})" if unknown else ""),
              file=sys.stderr)
        return None
    return tuple(CLASS_SPECS[n] for n in names)


def cmd_classifier_e2e(args) -> int:
    """Full classifier loop: synth dataset → chain → PNGs → train → report."""
    from fmcw_radar_processing_tpu_torch.models.experiment import (
        ExperimentConfig,
        report_markdown,
        run_classifier_experiment,
    )

    classes = _class_specs(args.classes)
    if classes is None:
        return 2
    cfg = ExperimentConfig(
        images_per_class=args.images_per_class,
        frames_per_recording=args.frames,
        model=args.model,
        epochs=args.epochs,
        batch_size=args.batch_size,
        learning_rate=args.lr,
        freeze_backbone=args.freeze_backbone,
        seed=args.seed,
        grad_clip_norm=args.grad_clip,
    )
    report = run_classifier_experiment(
        args.out_dir, cfg, classes,
        reuse_dataset=args.reuse_dataset, log_fn=print, device=args.device,
    )
    md = report_markdown(report)
    md_path = args.report or os.path.join(args.out_dir, "report.md")
    with open(md_path, "w") as f:
        f.write(md)
    print(md)
    print(f"report: {md_path} and {os.path.join(args.out_dir, 'report.json')}")
    return 0


def cmd_robustness(args) -> int:
    """Accuracy-vs-SNR robustness sweep (models/robustness.py)."""
    from fmcw_radar_processing_tpu_torch.models.robustness import (
        robustness_markdown,
        run_robustness_sweep,
    )

    classes = _class_specs(args.classes)
    if classes is None:
        return 2
    report = run_robustness_sweep(
        args.out_dir,
        model=args.model,
        classes=classes,
        train_images_per_class=args.train_images_per_class,
        test_images_per_class=args.test_images_per_class,
        frames_per_recording=args.frames,
        epochs=args.epochs,
        learning_rate=args.lr,
        grad_clip_norm=args.grad_clip,
        snr_grid_db=tuple(float(s) for s in args.snr_grid.split(",")),
        seed=args.seed,
        mixture_augment=args.mixture_augment,
        mixture_frac=args.mixture_frac,
        mixture_ratio=tuple(
            float(x) for x in args.mixture_ratio.split(",")),
        log_fn=print,
        device=args.device,
    )
    print(robustness_markdown(report))
    return 0


def cmd_config(args) -> int:
    from fmcw_radar_processing_tpu_torch.config import (
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
    pp.add_argument("--trace-dir",
                    help="capture a torch.profiler trace (Chrome JSON) into "
                         "this directory")
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

    pt = sub.add_parser("train", help="train the spectrogram classifier")
    pt.add_argument("--data-dir", required=True)
    pt.add_argument("--model", choices=["vgg16", "small"], default="small")
    pt.add_argument("--lr", type=float, default=1e-4)
    pt.add_argument("--epochs", type=int, default=10)
    pt.add_argument("--batch-size", type=int, default=32)
    pt.add_argument("--freeze-backbone", action="store_true")
    pt.add_argument("--checkpoint",
                    help="save a params-only checkpoint (params.npz) in this dir")
    pt.add_argument("--state-dir",
                    help="save FULL train state (params+optimizer+step) for --resume")
    pt.add_argument("--resume", help="resume from a --state-dir checkpoint")
    pt.add_argument("--export",
                    help="export a self-describing inference artifact "
                         "(params.npz + meta.json) for classify/serve")
    pt.add_argument("--device", default="cuda", help=device_help)
    pt.set_defaults(fn=cmd_train)

    pe = sub.add_parser(
        "classifier-e2e",
        help="end-to-end classifier loop: synth dataset -> chain -> PNGs -> "
             "train -> eval report -> servable artifact",
    )
    pe.add_argument("--out-dir", required=True)
    pe.add_argument("--images-per-class", type=int, default=192)
    pe.add_argument("--frames", type=int, default=128,
                    help="frames per synthesized recording")
    pe.add_argument("--model", choices=["vgg16", "small"], default="small")
    pe.add_argument("--epochs", type=int, default=10)
    pe.add_argument("--batch-size", type=int, default=32)
    pe.add_argument("--lr", type=float, default=1e-4,
                    help="Adam learning rate (notebook default 1e-4; "
                         "from-scratch training wants ~1e-3)")
    pe.add_argument("--freeze-backbone", action="store_true")
    pe.add_argument("--grad-clip", type=float, default=None,
                    help="global-norm gradient clip (from-scratch VGG16 "
                         "needs ~1.0; off by default = notebook setting)")
    pe.add_argument("--seed", type=int, default=42)
    pe.add_argument("--classes", default="calf,human",
                    help="comma-separated class pair from {human,calf,bees} "
                         "(notebook run 1: calf,human; run 2 = cells 27-29: "
                         "calf,bees)")
    pe.add_argument("--reuse-dataset", action="store_true",
                    help="skip generation if out_dir/raw already has images")
    pe.add_argument("--report", help="markdown report path (default out_dir/report.md)")
    pe.add_argument("--device", default="cuda", help=device_help)
    pe.set_defaults(fn=cmd_classifier_e2e)

    prb = sub.add_parser(
        "robustness",
        help="accuracy-vs-input-SNR sweep: train on clean data, evaluate "
             "on noise/amplitude/overlap-degraded chain outputs",
    )
    prb.add_argument("--out-dir", required=True)
    prb.add_argument("--model", choices=["vgg16", "small"], default="small")
    prb.add_argument("--epochs", type=int, default=10)
    prb.add_argument("--train-images-per-class", type=int, default=64)
    prb.add_argument("--test-images-per-class", type=int, default=24)
    prb.add_argument("--frames", type=int, default=128)
    prb.add_argument("--lr", type=float, default=1e-4)
    prb.add_argument("--grad-clip", type=float, default=1.0)
    prb.add_argument("--seed", type=int, default=42)
    prb.add_argument("--classes", default="calf,human")
    prb.add_argument("--snr-grid", default="40,25,15,10,5,0,-5",
                    help="comma-separated input-SNR grid in dB")
    prb.add_argument("--mixture-augment", action="store_true",
                    help="train with a fraction of images carrying a "
                         "sub-dominant other-class distractor in the same "
                         "range bin (dominant-class label)")
    prb.add_argument("--mixture-frac", type=float, default=0.5)
    prb.add_argument("--mixture-ratio", default="0.25,0.85",
                    help="comma-separated lo,hi distractor/primary "
                         "amplitude ratio range for training mixtures")
    prb.add_argument("--device", default="cuda", help=device_help)
    prb.set_defaults(fn=cmd_robustness)

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
