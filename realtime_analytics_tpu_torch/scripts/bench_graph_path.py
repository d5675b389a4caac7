"""Measure the ONNX-graph serving path against the native engine.

    python -m realtime_analytics_tpu_torch.scripts.bench_graph_path \\
        [--buckets 16,128] [--onnx PATH] [--device cuda|cpu]

The counterpart of the root ``scripts/bench_graph_path.py``. The graph path
trades the native engine's bf16, stem-folded, host-picked step for
fidelity: fp32 end to end, full 1080p frames uploaded and letterboxed on
the card (kernel B4 ``select``), the user's graph run node by node
(``models/onnx_torch.py``). This puts a number on that trade: the same
YOLOv8n (seeded weights, ``weights.synthetic_params``) served natively
(B3, B2, B1 twice, B6 a step) and as the graph the port's
``models/onnx_export.yolo_to_onnx`` writes from the same tree (B4, B1
twice, B6 a step), each timed by ``scripts/bench.py``'s differential at
each bucket from 1080p frames, as it serves: on the card the native step
replayed as a captured CUDA graph, the graph-backed step eager
(``engine/graphs.py``). The JAX script wrote its graph with a torch
mirror of the model and ``torch.onnx``; the port writes it itself.

Each row: ``step_ms``, ``ms_per_frame``, ``fps``, ``compute_dtype``,
``host_select``; then the graph / native ratio per bucket. The last line of
standard output is one JSON object of every row, with the card's name and
power limit. Without a card it exits 2 unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

INPUT = 640
SRC_HW = (1080, 1920)


def engine_for(model_path: str, buckets, device: str, params=None):
    from ..config import DetectorConfig
    from ..engine.detector import TorchYoloEngine

    graph = {"backend": "onnx"} if model_path.endswith(".onnx") else {}
    return TorchYoloEngine(DetectorConfig(
        model_path=model_path, model_type="yolov8", device=device,
        input_size=[INPUT, INPUT], batch_buckets=list(buckets),
        max_batch_size=max(buckets), warmup=False, **graph,
    ), params=params)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--buckets", default="16,128")
    ap.add_argument("--onnx", default=None,
                    help="the graph's path (written when missing; default: a temp dir)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_graph_path: no CUDA card visible; --device cpu runs on the CPU",
              file=sys.stderr)
        return 2
    from ..models.onnx_export import yolo_to_onnx
    from ..models.weights import synthetic_params
    from ..models.yolo import build_yolo
    from .bench import _diff_time_step, production_step
    from .profile_step import card_line

    buckets = [int(b) for b in args.buckets.split(",")]
    params = synthetic_params(build_yolo("yolov8", "n", 80), seed=0)
    tmp = tempfile.mkdtemp(prefix="rva_graph_path_")
    try:
        path = args.onnx or os.path.join(tmp, "yolov8n.onnx")
        if not os.path.exists(path):
            yolo_to_onnx(build_yolo("yolov8", "n", 80), params, path, (INPUT, INPUT))
            print(f"wrote {path}", file=sys.stderr, flush=True)
        rng = np.random.default_rng(0)
        rows = {}
        for label, model_path in (("native", "bench-seeded-weights"), ("graph", path)):
            eng = engine_for(model_path, buckets, args.device,
                             params if label == "native" else None)
            assert eng._graph_backed == (label == "graph"), label
            step, selected = production_step(eng, SRC_HW)
            for b in buckets:
                frames = rng.integers(0, 256, (b, *SRC_HW, 3), dtype=np.uint8)
                dev_in, _ = eng.host_prepare(frames, SRC_HW)
                x = torch.from_numpy(dev_in).to(eng.device)
                t0 = time.perf_counter()
                ms, seq_ms = _diff_time_step(step, x)
                rows[f"{label}_b{b}"] = {
                    "step_ms": round(ms, 3),
                    "ms_per_frame": round(ms / b, 4),
                    "fps": round(b / ms * 1e3, 1),
                    "seq_ms": round(seq_ms, 3),
                    "compute_dtype": str(eng.compute_dtype).replace("torch.", ""),
                    "host_select": bool(selected),
                    "warm_plus_measure_s": round(time.perf_counter() - t0, 1),
                }
                print(json.dumps({f"{label}_b{b}": rows[f"{label}_b{b}"]}),
                      file=sys.stderr, flush=True)
                del x
            del eng
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for b in buckets:
        rows[f"ratio_b{b}"] = round(rows[f"graph_b{b}"]["step_ms"]
                                    / rows[f"native_b{b}"]["step_ms"], 2)
    rows["platform"] = "gpu" if args.device == "cuda" else "cpu"
    rows["card"] = card_line() if args.device == "cuda" else None
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
