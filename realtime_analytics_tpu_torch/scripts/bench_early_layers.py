"""Time the early-layer segment of YOLOv8n (pad + cast + nodes 0..2).

    python -m realtime_analytics_tpu_torch.scripts.bench_early_layers \\
        [--batch 128] [--nodes 3] [--impl plain|kernel] [--device cuda|cpu]

The counterpart of the root ``scripts/bench_early_layers.py``. The stem
and the first C2f write the most activation bytes of the forward; this
times just that segment on host-picked input ([N, 360, 640, 3] uint8, the
exact 3x pick of 1080p frames), padded with 114 to 640 and cast to bf16 on
the card, by ``scripts/bench.py``'s differential (21 calls against 1):

* ``--impl plain``: nodes 0..``nodes - 1`` layer by layer (cuDNN convs);
* ``--impl kernel``: nodes 0 and 1 as kernel B3 (``ops/stem.py``
  ``fused_stem_p1p2``), then the rest layer by layer.

The line holds B3's launches in one call of the segment (1 for ``kernel``,
0 for ``plain``).

FLOPs come from ``torch.utils.flop_counter`` over the plain segment. The
JAX script's ``--impl pallas`` imports ``realtime_analytics_tpu.ops.
pallas_early``, which the JAX package does not have, so that branch never
ran there; the fused block that exists is B3, which ``kernel`` times.
The weights are seeded (``weights.synthetic_params``). The last line of
standard output is one JSON object. Without a card it exits 2 unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

SRC_HW = (1080, 1920)
INPUT_HW = (640, 640)
K_ITERS = 21


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--nodes", type=int, default=3,
                    help="leading nodes in the segment (3 = stem, P2 conv, first C2f)")
    ap.add_argument("--impl", choices=("plain", "kernel"), default="plain")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_early_layers: no CUDA card visible; --device cpu runs on the CPU",
              file=sys.stderr)
        return 2
    from torch.utils.flop_counter import FlopCounterMode

    from ..models.weights import params_from_jax, synthetic_params
    from ..models.yolo import build_yolo
    from ..ops import _cuda
    from ..ops.preprocess import letterbox_spec
    from ..ops.stem import fused_stem_p1p2
    from .bench import _diff_time_step
    from .profile_step import card_line

    device = torch.device(args.device)
    model = build_yolo("yolov8", "n", 80)
    params_from_jax(model, synthetic_params(model, seed=0))
    model.to(device=device, dtype=torch.bfloat16, memory_format=torch.channels_last).eval()
    if any(tuple(node.src) != (-1,) for node in model.nodes[1:args.nodes]):
        raise SystemExit(f"--nodes {args.nodes}: the segment must be a chain")
    if args.impl == "kernel" and args.nodes < 2:
        raise SystemExit("--impl kernel fuses nodes 0 and 1: --nodes must be >= 2")
    sw = model.stem_weights(torch.bfloat16)

    spec = letterbox_spec(SRC_HW, INPUT_HW)
    sel = np.random.default_rng(0).integers(
        0, 256, (args.batch, spec.new_h, spec.new_w, 3), dtype=np.uint8)

    def prep(f):
        x = torch.full((f.shape[0], spec.dst_h, spec.dst_w, 3), 114,
                       dtype=torch.bfloat16, device=f.device)
        x[:, spec.pad_top:spec.pad_top + spec.new_h,
          spec.pad_left:spec.pad_left + spec.new_w] = f
        return x

    def layers(y, start):
        for i in range(start, args.nodes):
            y = model.layers[str(i)](y)
        return y

    def plain(f):
        return (layers(prep(f).permute(0, 3, 1, 2), 0),)

    def kernel(f):
        return (layers(fused_stem_p1p2(prep(f), sw).permute(0, 3, 1, 2), 2),)

    segment = plain if args.impl == "plain" else kernel
    with torch.inference_mode():
        frames = torch.from_numpy(sel).to(device)
        with FlopCounterMode(display=False) as counter:
            plain(frames)
        flops = float(counter.get_total_flops())
        _cuda.LAUNCHES.reset()
        segment(frames)
        launches = _cuda.LAUNCHES.snapshot()
        ms, seq_ms = _diff_time_step(segment, frames, K_ITERS)
    print(json.dumps({
        "impl": args.impl,
        "batch": args.batch,
        "nodes": args.nodes,
        "segment_ms": round(ms, 4),
        "seq_ms": round(seq_ms, 4),
        "flops_g": round(flops / 1e9, 2),
        "tflops_per_s": round(flops / (ms / 1e3) / 1e12, 2),
        "fused_stem_launches": launches["fused_stem"],
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "card": card_line() if device.type == "cuda" else None,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
