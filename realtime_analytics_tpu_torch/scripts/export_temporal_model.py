"""Export / convert temporal model weights.

Counterpart of ``realtime_analytics_tpu/scripts/export_temporal_model.py``.
The reference ships a PyTorch->ONNX exporter with demo architectures
(scripts/convert_temporal_model_to_onnx.py:34-121) so that users can run
temporal pipelines without real checkpoints. Three flows:

  1. initialise a temporal model (seeded, ``weights.temporal_synthetic_params``)
     and save it (``--out model.npz`` params tree, or ``--out model.onnx``
     with torch-named initializers — readable by this package, the JAX
     package and standard ONNX tooling);
  2. convert a torch checkpoint (``--from-torch ckpt.pt``) whose module
     names follow the documented layout (c1/c2/c3/proj/lstm/fc, see
     ``models/weights.py::temporal_params_from_state_dict``) into either
     format;
  3. ``--verify``: reload through ``TorchTemporalEngine`` and run one clip
     (on the card unless ``--device cpu``).

Usage:
  python -m realtime_analytics_tpu_torch.scripts.export_temporal_model \\
      --model-type cnn_lstm --num-classes 400 --out models/cnn_lstm.onnx
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--model-type", required=True,
                   choices=["cnn_lstm", "3d_cnn", "conv_gru", "slow_fast"])
    p.add_argument("--num-classes", type=int, default=400)
    p.add_argument("--pooling", default="avg", choices=["avg", "max", "last"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--from-torch", default=None,
                   help="torch .pt/.pth state dict to convert (documented "
                        "module naming) instead of the seeded init")
    p.add_argument("--out", required=True,
                   help=".npz (native params tree) or .onnx (torch-named "
                        "initializers)")
    p.add_argument("--verify", action="store_true",
                   help="reload and run one clip through the engine")
    p.add_argument("--device", default="auto",
                   help="the --verify engine's device: auto|cuda|cuda:N (the card) or cpu")
    args = p.parse_args(argv)

    import torch

    from realtime_analytics_tpu_torch.models.temporal import build_temporal
    from realtime_analytics_tpu_torch.models.weights import (
        temporal_params_from_state_dict,
        temporal_state_dict_from_params,
        temporal_synthetic_params,
    )

    model = build_temporal(args.model_type, args.num_classes, args.pooling)
    if args.from_torch:
        obj = torch.load(args.from_torch, map_location="cpu", weights_only=False)
        if hasattr(obj, "state_dict"):
            obj = obj.float().state_dict()
        if "state_dict" in obj and isinstance(obj["state_dict"], dict):
            obj = obj["state_dict"]
        sd = {k: v.detach().cpu().numpy() for k, v in obj.items()}
        params = temporal_params_from_state_dict(model, sd)
    else:
        params = temporal_synthetic_params(model, seed=args.seed)

    if args.out.endswith(".onnx"):
        from realtime_analytics_tpu_torch.models.onnx_lite import write_onnx_initializers

        write_onnx_initializers(args.out, temporal_state_dict_from_params(model, params))
    else:
        np.savez(args.out, __pytree__=np.array(params, dtype=object))
    n_params = sum(int(np.prod(np.shape(a))) for a in _leaves(params))
    print(f"wrote {args.out}: {args.model_type}, {n_params/1e6:.2f}M params")

    if args.verify:
        import time

        from realtime_analytics_tpu_torch.config import DetectorConfig, StreamConfig
        from realtime_analytics_tpu_torch.engine.temporal import TorchTemporalEngine
        from realtime_analytics_tpu_torch.types import FramePacket

        cfg = DetectorConfig(
            model_path=args.out, model_type=args.model_type, device=args.device,
            sequence_length=8, num_action_classes=args.num_classes,
            confidence_threshold=1e-6,
        )
        eng = TorchTemporalEngine(cfg)
        stream = StreamConfig(name="verify", url="synthetic://")
        rng = np.random.default_rng(0)
        dets = []
        for i in range(8):
            frame = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
            dets = eng.predict(FramePacket(stream, frame, i, time.time()))
        print(f"verify: clip produced {len(dets)} TemporalDetections")
    return 0


def _leaves(tree):
    """The arrays of a params tree (nested dicts and lists)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
