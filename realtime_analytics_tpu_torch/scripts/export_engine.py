"""`realtime-analytics-torch-export`: build a serving artifact (.rvae).

Counterpart of ``realtime_analytics_tpu/scripts/export_engine.py``, the
analog of building a TensorRT engine from a checkpoint (reference
docs/inference_backends.md "TensorRT" workflow): load a checkpoint once,
export the serving step as ``torch.export`` programs for an explicit set of
source resolutions and batch buckets (``engine/export.py``), and write one
self-contained artifact that `detector.model_path: foo.rvae` serves from
directly, on the device types it was exported for: ``--platforms
cuda,cpu`` (JAX's flag) traces programs for each (``cuda`` needs a card;
``tpu`` is the JAX package's), by default the engine's device type (the
card; ``--device cpu`` for the CPU).

    realtime-analytics-torch-export --config config/sample-pipeline.yaml \
        --output yolov8n-h100.rvae --src 1080x1920 --src 480x854

or checkpoint-direct (no pipeline config):

    realtime-analytics-torch-export --model yolov8n.pt --output yolov8n.rvae \
        --src 1080x1920 --buckets 4,16,32

``--output x.onnx`` writes the native YOLO model as a standard ONNX graph
instead (``models/onnx_export.py::yolo_to_onnx``).
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import List, Tuple


def _parse_src(value: str) -> Tuple[int, int]:
    try:
        h, w = value.lower().split("x")
        return (int(h), int(w))
    except ValueError as exc:
        raise argparse.ArgumentTypeError(
            f"--src wants HxW (e.g. 1080x1920), got {value!r}"
        ) from exc


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="realtime-analytics-torch-export",
        description="export the serving step as torch.export programs in a .rvae artifact",
    )
    p.add_argument("--config", help="pipeline YAML; its detector section is used")
    p.add_argument(
        "--detector-id", default=None,
        help="named detector from the config's detectors map "
             "(default: the top-level detector)",
    )
    p.add_argument("--model", help="checkpoint path (overrides --config)")
    p.add_argument("--model-type", default=None,
                   help="yolov5|yolov8|resnet|cnn_lstm|3d_cnn|conv_gru|"
                        "slow_fast (default: from config, else yolov8)")
    p.add_argument("--output", required=True, help="artifact path (.rvae)")
    p.add_argument(
        "--input-size", type=_parse_src, default=None, metavar="HxW",
        help="model input size override (default: detector config)",
    )
    p.add_argument(
        "--src", action="append", type=_parse_src, metavar="HxW",
        help="source resolution to export (repeatable; default: the "
             "resolutions of the --config streams when statically "
             "knowable, else 1080x1920)",
    )
    p.add_argument(
        "--buckets", default=None,
        help="comma-separated batch buckets (default: detector config)",
    )
    p.add_argument(
        "--device", default=None,
        help="the engine's device: auto|cuda|cuda:N (the card) or cpu (default: "
             "detector config)",
    )
    p.add_argument(
        "--platforms", default=None,
        help="comma-separated export platforms, cuda and/or cpu (default: the "
             "engine's device type); the artifact serves on these only",
    )
    p.add_argument("--log-level", default="INFO")
    return p


def main(argv: List[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=args.log_level.upper(),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    from ..config import DetectorConfig, load_config
    from ..engine.detector import create_detector
    from ..engine.export import export_platforms, export_serving_artifact

    src_hws = args.src
    if args.config:
        pipe_cfg = load_config(args.config)
        if args.detector_id:
            try:
                det_cfg = pipe_cfg.detectors[args.detector_id]
            except KeyError:
                print(
                    f"no detector '{args.detector_id}' in {args.config} "
                    f"(has: {sorted(pipe_cfg.detectors) or 'none'})",
                    file=sys.stderr,
                )
                return 2
        else:
            det_cfg = pipe_cfg.detector
        if not src_hws:
            # the resolutions the pipeline would warm for this detector:
            # its streams' sizes (synthetic:// encodes them; RTSP/file
            # sources don't)
            from ..pipeline import _stream_source_hw

            def feeds(stream) -> bool:
                # mirror the pipeline's routing: a dangling detector_id
                # falls back to the default detector (pipeline.py)
                sid = stream.detector_id
                if sid not in pipe_cfg.detectors:
                    sid = None
                return sid == (args.detector_id or None)

            hws = {
                _stream_source_hw(s.url)
                for s in pipe_cfg.streams
                if s.enabled
                and feeds(s)
                and _stream_source_hw(s.url) is not None
            }
            if det_cfg.warmup_source_hw:
                hws.add(tuple(det_cfg.warmup_source_hw))
            src_hws = sorted(hws) or None
    else:
        det_cfg = DetectorConfig()
    if args.model:
        det_cfg.model_path = args.model
    if args.model_type:
        det_cfg.model_type = args.model_type
    if not args.model and not args.config:
        print("need --config or --model", file=sys.stderr)
        return 2
    if args.buckets:
        det_cfg.batch_buckets = [int(b) for b in args.buckets.split(",")]
        det_cfg.max_batch_size = max(det_cfg.batch_buckets)
    if args.input_size:
        det_cfg.input_size = list(args.input_size)
    if args.device:
        det_cfg.device = args.device
    det_cfg.warmup = False

    if args.output.endswith(".onnx"):
        # standard-ONNX export of the NATIVE model (models/onnx_export.py):
        # the interop/quantization route — .rvae stays the AOT-program route
        engine = create_detector(det_cfg)
        model = getattr(engine, "model", None)
        if model is None or not hasattr(model, "nodes"):
            print(".onnx export supports the native YOLO engine only "
                  "(resnet/temporal export .rvae, or use "
                  "export_temporal_model for torch-named weights)",
                  file=sys.stderr)
            return 2
        from ..models.onnx_export import yolo_to_onnx
        from ..models.weights import params_to_tree

        yolo_to_onnx(model, params_to_tree(model), args.output,
                     tuple(det_cfg.resolved_input_size))
        print(f"wrote {args.output}: yolov{model.version}{model.size} "
              f"nc={model.nc} input={tuple(det_cfg.resolved_input_size)}")
        return 0

    platforms = args.platforms.split(",") if args.platforms else None
    if platforms:
        try:  # refused before the engine is built
            export_platforms(platforms, "cpu")
        except (ValueError, RuntimeError) as exc:
            print(f"--platforms {args.platforms}: {exc}", file=sys.stderr)
            return 2
    engine = create_detector(det_cfg)  # any family: yolo/resnet/temporal
    meta = export_serving_artifact(
        engine,
        args.output,
        src_hws=src_hws or [(1080, 1920)],
        platforms=platforms,
    )
    print(
        f"wrote {args.output}: {len(meta['programs'])} program(s) "
        f"({', '.join(sorted({p['name'] for p in meta['programs']}))}), "
        f"platforms={meta['platforms']}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
