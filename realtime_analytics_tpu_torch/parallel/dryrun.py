"""A multi-device dry run: the sharded train step and sharded inference.

Counterpart of ``__graft_entry__.py::dryrun_multichip``: YOLOv8n at 64²,
nc 16, on an n-entry mesh, the three-axis (dp, sp, tp) one when 8 divides
n (8 -> 2, 2, 2; images split over dp and by height over sp), else JAX's
default (dp, tp) shape (4 -> 2, 2). Two full train steps (forward, loss,
backward, AdamW) over the mesh, then the trained weights served by a mesh
engine on 2 x dp frames at conf 0.005 (a barely trained model's scores sit
near 0.01), held against the same engine on one device. The (dp, tp)
engine is built from ``detector.mesh_shape``; the three-axis one, which no
config key names, through ``use_mesh``.

    python -c "from realtime_analytics_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; import torch; \\
        print(dryrun_multichip(8, [torch.device('cpu')] * 8))"
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..config import DetectorConfig
from ..engine.detector import TorchYoloEngine
from ..models.weights import params_to_tree
from ..models.yolo import build_yolo
from .mesh import AXES, AXES_SP, make_mesh
from .train import make_train_step, synthetic_targets


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> Dict:
    """Run the dry run on ``n_devices`` mesh entries (``devices``: as
    ``make_mesh`` takes them; None: the cards ``cuda:0..n-1``). Returns the
    mesh's shape, the two losses, the batch, the largest detection deltas
    against one device and the sharded forward's halo copies; raises if a loss is not finite or the
    sharded detections differ from one device's."""
    axes = AXES_SP if n_devices % 8 == 0 else AXES
    mesh = make_mesh(n_devices, axis_names=axes, devices=devices)
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    input_hw, nc, batch = (64, 64), 16, 2 * dp
    model = build_yolo("yolov8", "n", nc)
    rng = np.random.default_rng(0)

    init_fn, step_fn = make_train_step(model, input_hw, mesh=mesh)
    state = init_fn(0)
    images = rng.uniform(0, 1, (batch, *input_hw, 3)).astype(np.float32)
    targets = synthetic_targets(rng, batch, 4, input_hw, nc)
    state, loss = step_fn(state, images, targets)
    state, loss2 = step_fn(state, images, targets)
    losses = [float(loss), float(loss2)]
    if not np.isfinite(losses).all():
        raise RuntimeError(f"non-finite training loss: {losses}")

    kw = dict(model_path="yolov8n.pt", num_classes=nc, input_size=list(input_hw),
              confidence_threshold=0.005, max_batch_size=batch, batch_buckets=[batch],
              precision="fp32", warmup=False, pre_nms_topk=128, max_detections=32,
              device=str(mesh.lead(0)))
    tree = params_to_tree(model)
    if axes == AXES:
        sharded = TorchYoloEngine(DetectorConfig(mesh_shape=[dp, tp], **kw), params=tree,
                                  devices=list(mesh.devices.flat))
    else:
        sharded = TorchYoloEngine(DetectorConfig(**kw), params=tree)
        sharded.use_mesh(mesh)
    one = TorchYoloEngine(DetectorConfig(**kw), params=tree)
    frames = rng.integers(0, 256, (batch, 96, 128, 3), dtype=np.uint8)
    got, want = sharded.predict_arrays(frames), one.predict_arrays(frames)
    if not np.array_equal(got.num_valid, want.num_valid):
        raise RuntimeError(f"sharded num_valid {got.num_valid} != one device's "
                           f"{want.num_valid}")
    box_d, score_d = _set_deltas(got, want)
    if box_d > 1e-2 or score_d > 1e-4:
        raise RuntimeError(f"sharded detections differ from one device's: box {box_d}, "
                           f"score {score_d}")
    return dict(mesh=dict(mesh.shape), train_loss=losses, batch=batch,
                detections=int(got.num_valid.sum()), box_max_delta=box_d,
                score_max_delta=score_d, halo_copies=sharded.sharded.halo_copies)


def _set_deltas(got, want):
    """The largest box and score differences of two engines' detections,
    each detection paired with the nearest box of its class on the other
    side (NMS orders by score: detections whose scores tie to the last bit
    may swap slots, as a barely trained model's do)."""
    box_d = score_d = 0.0
    for i, n in enumerate(want.num_valid):
        free = list(range(int(n)))
        for j in range(int(n)):
            same = [k for k in free if want.class_ids[i, k] == got.class_ids[i, j]]
            if not same:
                return float("inf"), float("inf")
            k = min(same, key=lambda k: float(np.abs(got.boxes_xyxy[i, j]
                                                     - want.boxes_xyxy[i, k]).max()))
            free.remove(k)
            box_d = max(box_d, float(np.abs(got.boxes_xyxy[i, j] - want.boxes_xyxy[i, k]).max()))
            score_d = max(score_d, abs(float(got.scores[i, j]) - float(want.scores[i, k])))
    return box_d, score_d
