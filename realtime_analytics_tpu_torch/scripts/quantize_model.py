"""Post-training static quantization CLI: fp32 ONNX -> quantized ONNX.

The in-repo analog of the toolchain step the reference outsources: its
RKNN backend serves artifacts pre-quantized by the external RKNN
toolkit's calibration flow (reference detector.py:705-869), and its ONNX
path can consume onnxruntime-static-quantizer output. This CLI produces
such artifacts from any fp32 ONNX export the graph compiler serves:

    realtime-analytics-torch-quantize --model det.onnx --out det-int8.onnx \
        --calib frames.npz --format qdq

Calibration feeds come from an ``.npz``/``.npy`` of real inputs (first
axis = samples, each sample fed at batch 1), or ``--calib synthetic``
(uniform [0,1) noise at ``--input-shape``) for smoke runs. The output
serves through the same engines (``detector.model_path:`` the quantized
file, ``backend: onnx``) with int8 weights device-resident at one byte
per element; ``--format qoperator`` additionally collapses Conv(+Relu)/
MatMul into QLinearConv/QLinearMatMul so the integer compute runs as exact
s8 x s8 -> s32 products (``torch._int_mm`` on the card).

The port's copy of ``realtime_analytics_tpu/scripts/quantize_model.py``:
numpy only, with the port's ``letterbox_numpy`` for ``--calib-video``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

logger = logging.getLogger("realtime_analytics_tpu_torch.quantize")


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="realtime-analytics-torch-quantize",
        description="Post-training static quantization for ONNX graphs "
        "(QDQ or QOperator format), calibrated on sample inputs.",
    )
    p.add_argument("--model", required=True, help="fp32 .onnx input path")
    p.add_argument("--out", required=True, help="quantized .onnx output")
    p.add_argument(
        "--calib",
        default="synthetic",
        help=".npz/.npy of calibration inputs (first axis = samples), or "
        "'synthetic' for uniform [0,1) noise (default)",
    )
    p.add_argument(
        "--calib-video",
        default=None,
        help="calibrate on frames decoded from this video instead of "
        "--calib: frames are sampled evenly, letterboxed to the model "
        "input with the engine's exact preprocess (resize, 114 pad, "
        "BGR->RGB, /255), so calibration sees the serving distribution. "
        "Requires --input-shape C,H,W and cv2.",
    )
    p.add_argument(
        "--samples", type=int, default=16,
        help="calibration sample count (synthetic, or cap on file inputs)",
    )
    p.add_argument(
        "--input-shape", default=None,
        help="per-sample input shape for synthetic calibration, e.g. "
        "'3,640,640' (required with --calib synthetic)",
    )
    p.add_argument(
        "--format", choices=("qdq", "qoperator"), default="qdq",
        help="output format: QDQ (Q/DQ pairs, float compute, int8 "
        "weights; default) or QOperator (QLinearConv/QLinearMatMul, "
        "integer compute)",
    )
    p.add_argument(
        "--exclude", default="",
        help="comma-separated node names to leave float",
    )
    p.add_argument(
        "--weights-only", action="store_true",
        help="QDQ weights-only: quantize just the weight initializers "
        "(no calibration, no activation Q/DQ) — compression without "
        "activation quantization noise",
    )
    p.add_argument(
        "--check", action="store_true",
        help="after writing, re-read the artifact and report max abs/rel "
        "output difference vs the fp32 graph on one calibration sample",
    )
    p.add_argument("--log-level", default="INFO")
    return p.parse_args(argv)


def _load_calib_video(args, input_name: str):
    """Decode --samples frames (sampled evenly) from --calib-video and
    letterbox each to the model input with the engine's exact preprocess
    (ops/preprocess.letterbox_numpy: min-scale resize, 114 pad, BGR->RGB,
    /255) so calibration sees the serving activation distribution."""
    try:
        import cv2
    except ImportError as exc:  # pragma: no cover - env dependent
        raise SystemExit("--calib-video requires cv2 (opencv)") from exc

    from realtime_analytics_tpu_torch.ops.preprocess import letterbox_numpy

    if not args.input_shape:
        raise SystemExit("--calib-video requires --input-shape C,H,W")
    shape = tuple(int(d) for d in args.input_shape.split(","))
    if len(shape) != 3 or shape[0] != 3:
        raise SystemExit(
            f"--input-shape must be 3,H,W for video calibration, "
            f"got {args.input_shape}"
        )
    dst_hw = (shape[1], shape[2])
    cap = cv2.VideoCapture(args.calib_video)
    if not cap.isOpened():
        raise SystemExit(f"cannot open video: {args.calib_video}")
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) or 0
        stride = max(1, total // args.samples) if total else 1
        feeds = []
        idx = 0
        while len(feeds) < args.samples:
            ok, frame = cap.read()
            if not ok:
                break
            if idx % stride == 0:
                tensor, _meta = letterbox_numpy(frame, dst_hw)
                feeds.append({input_name: tensor})
            idx += 1
    finally:
        cap.release()
    if not feeds:
        raise SystemExit(f"no frames decoded from {args.calib_video}")
    logger.info(
        "calibrating on %d frame(s) from %s (letterboxed to %s)",
        len(feeds), args.calib_video, dst_hw,
    )
    return feeds


def _load_calib(args, input_name: str):
    if args.calib_video:
        return _load_calib_video(args, input_name)
    if args.calib == "synthetic":
        if not args.input_shape:
            raise SystemExit(
                "--input-shape C,H,W is required with --calib synthetic"
            )
        shape = tuple(int(d) for d in args.input_shape.split(","))
        rng = np.random.default_rng(0)
        return [
            {input_name: rng.random((1, *shape), dtype=np.float32)}
            for _ in range(args.samples)
        ]
    if not os.path.exists(args.calib):
        raise SystemExit(f"calibration file not found: {args.calib}")
    if args.calib.endswith(".npz"):
        with np.load(args.calib) as z:
            arr = z[list(z.files)[0]]
    else:
        arr = np.load(args.calib)
    arr = np.asarray(arr, dtype=np.float32)
    n = min(args.samples, arr.shape[0])
    return [{input_name: arr[i : i + 1]} for i in range(n)]


def main(argv=None) -> int:
    args = _parse_args(argv)
    logging.basicConfig(
        level=args.log_level.upper(),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    # quantization runs entirely on the numpy executor: no torch, no card
    from realtime_analytics_tpu_torch.models.onnx_exec import run_graph
    from realtime_analytics_tpu_torch.models.onnx_lite import (
        read_onnx_model,
        write_onnx_model,
    )
    from realtime_analytics_tpu_torch.models.quantize import quantize_graph

    g = read_onnx_model(args.model)
    if len(g.inputs) != 1:
        raise SystemExit(
            f"expected exactly one graph input, found {g.inputs}"
        )
    input_name = g.inputs[0]
    feeds = [] if args.weights_only else _load_calib(args, input_name)
    if args.weights_only and not args.input_shape:
        raise SystemExit("--weights-only still needs --input-shape for "
                         "the artifact's typed IO (or use --calib)")
    exclude = [s for s in args.exclude.split(",") if s]
    qg, report = quantize_graph(g, feeds, fmt=args.format, exclude=exclude,
                                weights_only=args.weights_only)
    if feeds:
        sample = np.asarray(feeds[0][input_name])
    else:  # weights-only: one zero sample just for typed IO + --check
        shape = tuple(int(d) for d in args.input_shape.split(","))
        sample = np.zeros((1, *shape), dtype=np.float32)
        feeds = [{input_name: sample}]
    # typed IO for strict ONNX loaders: outputs typed from one evaluated
    # sample (batch axis dynamic, matching the input)
    value_infos = {input_name: (np.float32, ("n",) + sample.shape[1:])}
    for out_name, arr in zip(qg.outputs,
                             run_graph(qg, {input_name: sample})):
        arr = np.asarray(arr)
        value_infos[out_name] = (arr.dtype, ("n",) + arr.shape[1:])
    write_onnx_model(args.out, qg, value_infos=value_infos)
    in_sz = os.path.getsize(args.model)
    out_sz = os.path.getsize(args.out)
    logger.info("%s", report.summary())
    logger.info(
        "wrote %s (%s): %.1f KiB -> %.1f KiB (%.2fx)",
        args.out, args.format, in_sz / 1024, out_sz / 1024,
        in_sz / max(out_sz, 1),
    )
    if args.check:
        g2 = read_onnx_model(args.out)
        want = run_graph(g, {input_name: sample})
        got = run_graph(g2, {input_name: sample})
        for w, q in zip(want, got):
            w = np.asarray(w, dtype=np.float32)
            q = np.asarray(q, dtype=np.float32)
            abs_err = float(np.abs(q - w).max()) if w.size else 0.0
            rel = abs_err / (float(np.abs(w).max()) + 1e-9)
            logger.info(
                "check: max abs err %.5f (rel %.4f) on one sample",
                abs_err, rel,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
