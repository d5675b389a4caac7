"""``realtime-analytics-torch-train``: fine-tune a detection model in-framework.

Counterpart of ``realtime_analytics_tpu/scripts/train.py``, with the same
flags and defaults: the train step of ``parallel/train.py`` (forward,
anchor-free detection loss, backward, AdamW) on one card, or on the CPU
with ``--device cpu``. ``--device auto`` (the default) is the card and
raises when none is visible. The step's kernels are deterministic (one
trajectory a seed). ``--mesh DP,TP`` trains over a (dp, tp) mesh
(``parallel/mesh.py``): the cards ``cuda:0..DP*TP-1``, or DP*TP entries of
the CPU with ``--device cpu``.

Built-in data: the synthetic video source renders moving rectangles AND
knows their ground-truth boxes (``SyntheticSource.read_labeled``), so the
CLI trains/evaluates end to end with zero datasets.

The checkpoint (``--out``, a ``__pytree__`` .npz in the JAX package's
params layout) loads straight back into the serving engine of either
package:
  realtime-analytics-torch-train --steps 300 --out models/synth.npz
  # then detector.model_path: models/synth.npz

Resume checkpoints (``--checkpoint-dir``) are this trainer's own:
``{"params": tree, "opt_state": {"count": int, "mu": tree, "nu": tree},
"step": int}``, plain dicts of numpy arrays in the params' layout (no
pickled class). The JAX trainer's ``train_state.npz`` (optax's state) is
refused with a message.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import time
import zipfile

import numpy as np


def synthetic_batch(sources, input_hw, max_boxes):
    """One labeled batch from N synthetic sources: images normalized [0,1]
    RGB at input_hw, padded target boxes/classes/mask."""
    import cv2

    n = len(sources)
    h, w = input_hw
    images = np.empty((n, h, w, 3), np.float32)
    boxes = np.zeros((n, max_boxes, 4), np.float32)
    classes = np.zeros((n, max_boxes), np.int32)
    mask = np.zeros((n, max_boxes), bool)
    for i, src in enumerate(sources):
        ok, frame, gt, cls = src.read_labeled()
        if not ok:
            raise RuntimeError("synthetic source ended")
        sy, sx = h / frame.shape[0], w / frame.shape[1]
        resized = cv2.resize(frame, (w, h), interpolation=cv2.INTER_LINEAR)
        images[i] = resized[..., ::-1].astype(np.float32) / 255.0
        m = min(len(gt), max_boxes)
        boxes[i, :m] = gt[:m] * np.asarray([sx, sy, sx, sy], np.float32)
        classes[i, :m] = cls[:m]
        mask[i, :m] = True
    return images, {"boxes": boxes, "classes": classes, "mask": mask}


def mean_best_iou(engine, sources, input_hw, n_frames=8):
    """Detection quality probe: mean IoU of the best detection per GT box."""
    import torch

    from ..ops.boxes import iou_matrix

    total, count = 0.0, 0
    for src in sources[:4]:
        for _ in range(max(1, n_frames // 4)):
            ok, frame, gt, _cls = src.read_labeled()
            if not ok:
                return 0.0
            br = engine.predict_arrays(frame[None])
            nv = int(br.num_valid[0])
            if nv == 0:
                count += len(gt)
                continue
            ious = iou_matrix(torch.from_numpy(np.asarray(gt, np.float32)),
                              torch.from_numpy(br.boxes_xyxy[0, :nv])).numpy()
            total += float(ious.max(axis=1).sum())
            count += len(gt)
    return total / max(count, 1)


class _ArraysOnly(pickle.Unpickler):
    """Unpickles numpy arrays inside builtin containers and nothing else:
    a file that needs another class (the JAX trainer's optax state) fails
    here instead of importing that class's package."""

    _ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype"),
                ("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "_reconstruct")}

    def find_class(self, module, name):
        if (module, name) not in self._ALLOWED:
            raise pickle.UnpicklingError(f"holds a pickled {module}.{name}")
        return super().find_class(module, name)


def read_train_state(path: str):
    """The resume file's tree; ValueError (with the reason) when it is not
    this trainer's layout."""
    try:
        with zipfile.ZipFile(path) as zf, zf.open("__pytree__.npy") as fh:
            version = np.lib.format.read_magic(fh)
            _, _, dtype = (np.lib.format.read_array_header_1_0(fh) if version == (1, 0)
                           else np.lib.format.read_array_header_2_0(fh))
            if dtype != np.dtype(object):
                raise ValueError(f"__pytree__ is {dtype}, not a tree")
            tree = _ArraysOnly(fh).load().item()
    except (OSError, KeyError, zipfile.BadZipFile, pickle.UnpicklingError) as exc:
        raise ValueError(str(exc)) from exc
    if not (isinstance(tree, dict) and set(tree) == {"params", "opt_state", "step"}
            and isinstance(tree["opt_state"], dict)
            and set(tree["opt_state"]) == {"count", "mu", "nu"}):
        raise ValueError("not {'params', 'opt_state': {'count', 'mu', 'nu'}, 'step'}")
    return tree


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="realtime-analytics-torch-train")
    p.add_argument("--model-type", default="yolov8", choices=["yolov8", "yolov5"])
    p.add_argument("--size", default="n", choices=list("nsmlx"))
    p.add_argument("--nc", type=int, default=8, help="number of classes")
    p.add_argument("--input-size", type=int, nargs=2, default=[128, 128],
                   metavar=("H", "W"))
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--boxes-per-image", type=int, default=3)
    p.add_argument("--mesh", default=None, metavar="DP,TP",
                   help="e.g. 4,2 — the train step over a (dp, tp) device mesh")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init-from", default=None,
                   help="checkpoint to fine-tune from (.pt/.npz/.onnx)")
    p.add_argument("--out", default=None, help="save .npz pytree checkpoint")
    p.add_argument("--eval", action="store_true",
                   help="report detection IoU before/after training")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--checkpoint-dir", default=None,
                   help="periodic FULL train-state checkpoints (params + "
                        "optimizer state + step) for crash-safe resume")
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--resume", action="store_true",
                   help="continue from --checkpoint-dir's latest state")
    p.add_argument("--device", default="auto",
                   help="auto | cuda | cuda:N (the card; raises without one) | cpu")
    args = p.parse_args(argv)

    from ..config import DetectorConfig
    from ..engine.detector import pick_device
    from ..ingest.synthetic import SyntheticSource
    from ..models.weights import load_yolo_checkpoint, params_from_jax, params_to_tree
    from ..models.yolo import build_yolo
    from ..parallel.mesh import make_mesh
    from ..parallel.train import load_opt_state_tree, make_train_step, opt_state_tree

    input_hw = tuple(args.input_size)
    device = pick_device(DetectorConfig(device=args.device))
    model = build_yolo(args.model_type, args.size, nc=args.nc)
    mesh = None
    if args.mesh:
        dp, tp = (int(v) for v in args.mesh.split(","))
        mesh = make_mesh(dp * tp, shape=(dp, tp),
                         devices=[device] * (dp * tp) if device.type == "cpu" else None)
    init_fn, step_fn = make_train_step(model, input_hw, learning_rate=args.lr,
                                       device=device, mesh=mesh)

    sources = [
        SyntheticSource(width=input_hw[1] * 2, height=input_hw[0] * 2,
                        boxes=args.boxes_per_image, seed=args.seed + i)
        for i in range(args.batch)
    ]

    def as_engine():
        from ..engine.detector import TorchYoloEngine

        cfg = DetectorConfig(
            model_path="__trained__.pt", model_type=args.model_type,
            num_classes=args.nc, input_size=list(input_hw),
            confidence_threshold=0.10, warmup=False, precision="fp32",
            max_batch_size=1, batch_buckets=[1], pre_nms_topk=256,
            max_detections=16, device=args.device,
        )
        return TorchYoloEngine(cfg, params=params_to_tree(model))

    ckpt_path = None
    if args.checkpoint_dir:
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        ckpt_path = os.path.join(args.checkpoint_dir, "train_state.npz")

    def save_state(state):
        """Atomic full-state checkpoint: params + optimizer state + step,
        plain dicts of numpy arrays in the params' layout."""
        host = {"params": params_to_tree(model),
                "opt_state": opt_state_tree(model, state.opt_state, state.net),
                "step": int(state.step)}
        tmp = ckpt_path + ".tmp.npz"
        np.savez(tmp, __pytree__=np.array(host, dtype=object))
        os.replace(tmp, ckpt_path)

    state = init_fn(args.seed)
    resumed = False
    if args.resume and ckpt_path:
        if os.path.exists(ckpt_path):
            try:
                tree = read_train_state(ckpt_path)
                params_from_jax(model, tree["params"])
                if state.net is not None:
                    state.net.scatter_from_module()
                load_opt_state_tree(model, state.opt_state, tree["opt_state"], state.net)
            except (ValueError, KeyError) as exc:
                print(f"--resume: {ckpt_path} is not this trainer's resume layout "
                      f"({exc}); the JAX trainer's optax state does not load here",
                      file=sys.stderr)
                return 1
            resumed = True
            state = state._replace(step=int(tree["step"]))
            print(f"resumed from {ckpt_path} at step {state.step}")
        else:
            print(f"--resume: no checkpoint at {ckpt_path}, starting fresh")
    # --init-from seeds a FRESH run only: a resumed checkpoint already
    # contains the (further-trained) params plus matching optimizer
    # moments — overwriting the params here would silently discard the
    # training progress while keeping stale Adam state
    if args.init_from and not resumed:
        loaded = load_yolo_checkpoint(model, args.init_from)
        if loaded is None:
            print(f"could not load --init-from {args.init_from}", file=sys.stderr)
            return 1
        params_from_jax(model, loaded)
        if state.net is not None:
            state.net.scatter_from_module()

    if args.eval:
        iou0 = mean_best_iou(as_engine(), sources, input_hw)
        print(f"eval before: mean best-IoU {iou0:.3f}")

    t0 = time.perf_counter()
    first = last = None
    # resume completes the ORIGINAL step budget: a run restored at step
    # k performs steps k+1..args.steps, and checkpoint cadence keys to
    # the global step, not a restarted loop counter
    start_step = state.step + 1
    if start_step > args.steps:
        print(f"checkpoint already at step {start_step - 1} >= "
              f"--steps {args.steps}; nothing to do")
    for step in range(start_step, args.steps + 1):
        images, targets = synthetic_batch(sources, input_hw, args.boxes_per_image)
        state, loss = step_fn(state, images, targets)
        if ckpt_path and (step % args.checkpoint_every == 0 or step == args.steps):
            save_state(state)
        if step == 1 or step % args.log_every == 0 or step == args.steps:
            loss_v = float(loss)
            first = first if first is not None else loss_v
            last = loss_v
            rate = (step - start_step + 1) * args.batch / (time.perf_counter() - t0)
            print(f"step {step:5d}  loss {loss_v:8.4f}  ({rate:.1f} images/s)")

    if args.eval:
        iou1 = mean_best_iou(as_engine(), sources, input_hw)
        print(f"eval after:  mean best-IoU {iou1:.3f}")

    if args.out:
        np.savez(args.out, __pytree__=np.array(params_to_tree(model), dtype=object))
        print(f"saved {args.out} (loads via detector.model_path)")
    if first is not None and last is not None and last >= first:
        print("warning: loss did not decrease", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
