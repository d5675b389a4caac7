"""YOLO detection engine on PyTorch, one step per (bucket, source size).

Counterpart of ``realtime_analytics_tpu/engine/detector.py``
(``JaxYoloEngine``). The chain per batch is the same:

    uint8 NHWC batch -> (host pixel pick) -> pad + cast on the card
        -> YOLOv8 forward (BGR->RGB and /255 folded into the stem weights)
        -> confidence/class masking -> batched NMS -> un-letterbox

PyTorch runs eagerly, so a "step" is a closure over the static letterbox
geometry, not a compiled program. Batches are still padded to the
configured buckets, so every call sees one of a few fixed shapes.

Device rules: ``device: auto | cuda | cuda:N`` means the card and RAISES
when none is visible; only ``device: cpu`` runs on the CPU. On the card the
three ported kernels (B1 gather, B2 decode, B3 stem) launch under their
``pallas_*`` knobs; on the CPU the same knobs take the kernels' plain
versions.

Numerics: ``precision: fp32`` means fp32 — on the card the engine turns
TF32 off for cuDNN convolutions and for matmuls (cuDNN defaults to TF32).
``half: true`` or ``precision: bf16`` means bf16, as in the JAX package.

Concurrency: the batcher runs up to ``pipeline_depth`` ``predict_packets``
calls at once in worker threads. Each call allocates its own device
tensors; the only shared device state is read-only weights.
"""

from __future__ import annotations

import abc
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DetectorConfig, TEMPORAL_MODEL_TYPES
from ..models.weights import load_yolo_checkpoint, params_from_jax
from ..models.yolo import build_yolo, size_from_model_path
from ..ops.boxes import unletterbox_boxes
from ..ops.nms import batched_nms
from ..ops.preprocess import integer_axis_reduction, letterbox_spec, preprocess_batch
from ..types import BatchResult, Detection, FramePacket

logger = logging.getLogger(__name__)

_NOT_PORTED = " is not ported to the PyTorch package yet — see ROADMAP.md"


class BaseDetector(abc.ABC):
    """Single-packet predict interface (reference detector.py:43-51)."""

    config: DetectorConfig

    @abc.abstractmethod
    def predict(self, packet: FramePacket) -> List[Detection]:
        raise NotImplementedError

    def close(self) -> None:  # pragma: no cover - optional override
        pass


def pick_device(config: DetectorConfig) -> torch.device:
    """``cpu`` -> the CPU; ``auto``/``cuda``/``cuda:N`` -> that card, and an
    error when no card is visible (never a silent CPU fallback)."""
    dev = str(config.device).lower()
    if dev == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"detector.device={config.device!r} needs a CUDA card and none "
            "is visible; set detector.device: cpu to run on the CPU"
        )
    if dev in ("auto", "cuda"):
        return torch.device("cuda", torch.cuda.current_device())
    index = int(dev.split(":", 1)[1])
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"detector.device={config.device!r}: only "
            f"{torch.cuda.device_count()} card(s) visible"
        )
    return torch.device("cuda", index)


def _bucket_for(buckets: Sequence[int], n: int) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _cheapest_bucket(buckets: Sequence[int], n: int, costs: Dict[int, float]) -> int:
    """The cheapest bucket >= n by measured step cost, else the smallest."""
    bucket = _bucket_for(buckets, n)
    if costs:
        cands = [b for b in buckets if b >= n and b in costs]
        if cands:
            bucket = min(cands, key=lambda b: (costs[b], b))
    return bucket


class TorchYoloEngine(BaseDetector):
    """YOLOv8 engine with batched inference on one card (or the CPU)."""

    def __init__(self, config: DetectorConfig, params: Optional[Dict] = None):
        config.validate()
        self.config = config
        if config.precision == "int8":
            raise NotImplementedError("precision: int8" + _NOT_PORTED)
        if config.mesh_shape:
            raise NotImplementedError("detector.mesh_shape (multi-device)" + _NOT_PORTED)
        if config.tiling:
            raise NotImplementedError("detector.tiling" + _NOT_PORTED)
        self.device = pick_device(config)
        if self.device.type == "cuda":
            # precision: fp32 means fp32: cuDNN convolutions default to TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = build_yolo(
            config.model_type if config.model_type in ("yolov5", "yolov8") else "yolov8",
            size_from_model_path(config.model_path), config.num_classes,
        )
        self.input_hw: Tuple[int, int] = config.resolved_input_size
        self.compute_dtype = (
            torch.float32
            if config.precision == "fp32" and not config.half
            else torch.bfloat16
        )
        if params is None:
            params = load_yolo_checkpoint(self.model, config.model_path)
        if params is None:
            logger.warning(
                "No loadable weights at '%s' — using a seeded random init "
                "(seed 0). Detections will be meaningless until a checkpoint "
                "is provided.", config.model_path,
            )
            self.model.init_params(torch.Generator().manual_seed(0))
        else:
            params_from_jax(self.model, params)
        self.model.to(device=self.device, dtype=self.compute_dtype,
                      memory_format=torch.channels_last).eval()
        if config.s2d_backbone != "off":
            logger.info(
                "detector.s2d_backbone=%s is a TPU layout tactic of the JAX "
                "package; it is a no-op on the PyTorch engine",
                config.s2d_backbone,
            )
        self.model.pallas_decode = "off" if config.pallas_decode == "off" else "on"
        self.model.pallas_stem = "off" if config.pallas_stem == "off" else "on"
        self._nms_gather = "torch" if config.pallas_gather == "off" else "kernel"
        # BGR->RGB and /255 are linear in the input, so the selected step
        # folds them into the stem conv (input-channel flip + scale). Done
        # once here, in the compute dtype, in the JAX order: the weights
        # were cast above, then flip and scale.
        w0 = self.model.layers["0"].weight
        self._w0_folded = torch.flip(w0, dims=[1]) * torch.tensor(
            1.0 / 255.0, dtype=w0.dtype, device=w0.device
        )
        self._stem_folded = self.model.stem_weights(self.compute_dtype, self._w0_folded)
        self._stem_plain = self.model.stem_weights(self.compute_dtype)
        self._class_mask = None
        if config.classes:
            mask = torch.zeros(config.num_classes, dtype=torch.bool)
            mask[torch.as_tensor(config.classes, dtype=torch.long)] = True
            self._class_mask = mask.to(self.device)
        self._bucket_cost_ms: Dict[Tuple[int, int], Dict[int, float]] = {}
        self.class_agnostic_nms = True  # reference NMS is class-agnostic
        self.last_infer_ms: float = 0.0
        self._b4_note_logged = False

    # -- host side ------------------------------------------------------

    @staticmethod
    def _select_geometry(spec) -> Optional[Tuple[int, int, int, int]]:
        """(hr, hoff, wr, woff) when both axis ratios are odd integers (or
        1) — the resize is then an exact pixel pick (1080p -> 640 is exactly
        3x). None otherwise."""

        def axis(src: int, new: int):
            if src == new:
                return ("select", 1, 0)
            return integer_axis_reduction(src, new)

        h = axis(spec.src_h, spec.new_h)
        w = axis(spec.src_w, spec.new_w)
        if h is not None and w is not None and h[0] == w[0] == "select":
            return (h[1], h[2], w[1], w[2])
        return None

    def host_prepare(self, frames: np.ndarray, src_hw: Tuple[int, int]):
        """(prepared uint8 array to upload, selected: bool). An exact pixel
        pick happens here on the host (``host_select``), so only the kept
        pixels cross the link (0.7 MB instead of 6 MB per 1080p frame);
        fractional ratios take the host cv2 letterbox resize when
        ``host_resize`` is active."""
        spec = letterbox_spec(src_hw, self.input_hw)
        if self.config.host_select != "off":
            geom = self._select_geometry(spec)
            if geom is not None:
                from ..native import pick_u8

                hr, hoff, wr, woff = geom
                return pick_u8(frames, hr, hoff, wr, woff), True
        if self._host_resize_active():
            resized = self._host_resize_packets(frames, spec)
            if resized is not None:
                return resized, True
        return frames, False

    def _host_resize_active(self) -> bool:
        """auto = on for the card (as the JAX package does for its TPU:
        upload the resized content, run the lean selected step), off for
        the CPU."""
        return self.config.host_resize == "on" or (
            self.config.host_resize == "auto" and self.device.type == "cuda"
        )

    @staticmethod
    def _host_resize_packets(frames, spec) -> Optional[np.ndarray]:
        """cv2 INTER_LINEAR resize of each frame to the letterbox content
        size, straight into one batch buffer. None when cv2 is unavailable
        or the geometry is a no-op."""
        if (spec.new_h, spec.new_w) == (spec.src_h, spec.src_w):
            return None
        try:
            import cv2
        except ImportError:
            return None
        out = np.empty((len(frames), spec.new_h, spec.new_w, 3), dtype=np.uint8)
        for i, frame in enumerate(frames):
            cv2.resize(frame, (spec.new_w, spec.new_h), dst=out[i],
                       interpolation=cv2.INTER_LINEAR)
        return out

    # -- device steps -----------------------------------------------------

    def _final_select(self, out):
        """Model output -> padded per-image (boxes, scores, classes,
        num_valid) through the class mask, the confidence threshold and
        batched NMS."""
        cfg = self.config
        boxes = out["boxes_xyxy"].to(torch.float32)
        conf = out["conf"]
        cls = out["cls"]
        if self._class_mask is not None:
            conf = torch.where(self._class_mask[cls.long()], conf, 0.0)
        conf = torch.where(conf >= cfg.confidence_threshold, conf, 0.0)
        return batched_nms(
            boxes, conf, cls,
            iou_threshold=cfg.iou_threshold,
            max_det=cfg.max_detections,
            pre_topk=min(cfg.pre_nms_topk, boxes.shape[1]),
            class_agnostic=self.class_agnostic_nms,
            gather_impl=self._nms_gather,
        )

    def _pad_cast(self, sel_u8: torch.Tensor, spec) -> torch.Tensor:
        """Host-picked [B, new_h, new_w, 3] uint8 BGR -> the letterboxed
        model input [B, dst_h, dst_w, 3] in the compute dtype at pixel
        scale, padded with 114."""
        b = sel_u8.shape[0]
        x = torch.full((b, spec.dst_h, spec.dst_w, 3), 114,
                       dtype=self.compute_dtype, device=self.device)
        x[:, spec.pad_top:spec.pad_top + spec.new_h,
          spec.pad_left:spec.pad_left + spec.new_w] = sel_u8
        return x

    def _forward_selected(self, x: torch.Tensor):
        """The model on a ``_pad_cast`` input: the stem-folded weights take
        raw BGR pixels."""
        return self.model(x, reduce_scores=True, w0=self._w0_folded,
                          stem_weights=self._stem_folded)

    def _step_selected(self, sel_u8: torch.Tensor, spec):
        """Over host-picked input: pad + cast, forward with the stem-folded
        weights, NMS, un-letterbox to the ORIGINAL source geometry."""
        out = self._forward_selected(self._pad_cast(sel_u8, spec))
        return self._finish(out, spec)

    def _step_device_resize(self, frames_u8: torch.Tensor, spec):
        """Over full frames [B, H, W, 3] uint8 BGR: plain device letterbox
        (``preprocess_batch``), forward, NMS, un-letterbox."""
        mode = self.config.pallas_preprocess
        if self.device.type == "cuda":
            if mode == "on":
                raise NotImplementedError(
                    "pallas_preprocess: on — the bilinear letterbox kernel "
                    "(B4)" + _NOT_PORTED
                )
            if mode == "auto" and not self._b4_note_logged:
                self._b4_note_logged = True
                logger.info(
                    "pallas_preprocess: auto — the letterbox kernel (B4) is "
                    "not ported yet; the device resize takes the plain "
                    "PyTorch preprocess"
                )
        x = preprocess_batch(frames_u8, spec=spec, out_dtype=self.compute_dtype,
                             layout="NHWC")
        out = self.model(x, reduce_scores=True, stem_weights=self._stem_plain)
        return self._finish(out, spec)

    def _finish(self, out, spec):
        b, s, c, n = self._final_select(out)
        b = unletterbox_boxes(b, spec.scale, spec.pad_left, spec.pad_top,
                              spec.src_h, spec.src_w)
        return b, s, c, n

    # -- buckets ----------------------------------------------------------

    def _effective_bucket(self, n: int, src_hw: Tuple[int, int]) -> int:
        """The cheapest warmed bucket that fits n frames, for THIS source
        resolution (costs are per resolution), else the smallest."""
        return _cheapest_bucket(
            self.config.resolved_buckets, n,
            self._bucket_cost_ms.get(tuple(src_hw), {}),
        )

    def warmup(self, src_hw: Tuple[int, int], buckets: Optional[Sequence[int]] = None):
        """Run every bucket once to settle allocations, cuDNN algorithm
        choice and the first-use kernel build, then time it (min of 3) for
        cost-aware bucket selection."""
        buckets = buckets or self.config.resolved_buckets
        _, selected = self.host_prepare(np.zeros((1, *src_hw, 3), np.uint8), src_hw)
        costs = self._bucket_cost_ms.setdefault(tuple(src_hw), {})
        for b in buckets:
            b0 = _bucket_for(self.config.resolved_buckets, b)
            prepared, _ = self.host_prepare(
                np.zeros((b0, *src_hw, 3), dtype=np.uint8), src_hw
            )
            self._run_bucket(b0, prepared, src_hw, selected)
            cost = float("inf")
            for _ in range(3):
                self._run_bucket(b0, prepared, src_hw, selected)
                cost = min(cost, self.last_infer_ms)
            costs[b0] = cost
            logger.info(
                "warmup: bucket B=%d src=%s (host_select=%s) step=%.1fms",
                b0, src_hw, selected, cost,
            )

    # -- prediction -------------------------------------------------------

    def predict_arrays(self, frames: np.ndarray) -> BatchResult:
        """frames: [N, H, W, 3] uint8 BGR (all same resolution)."""
        src_hw = tuple(frames.shape[1:3])
        frames, selected = self.host_prepare(frames, src_hw)
        return self._predict_prepared(frames, src_hw, selected)

    def _predict_prepared(self, frames: np.ndarray, src_hw: Tuple[int, int],
                          selected: bool) -> BatchResult:
        n = frames.shape[0]
        bucket = self._effective_bucket(n, src_hw)
        if n > bucket:
            raise ValueError(f"batch {n} exceeds max bucket {bucket}")
        return self._run_bucket(bucket, frames, src_hw, selected)

    def _run_bucket(self, bucket: int, frames: np.ndarray,
                    src_hw: Tuple[int, int], selected: bool) -> BatchResult:
        """Pad to exactly ``bucket`` and run the step (warmup uses this
        directly to time a specific bucket)."""
        n = frames.shape[0]
        if n < bucket:
            pad = np.zeros((bucket - n, *frames.shape[1:]), dtype=frames.dtype)
            frames = np.concatenate([frames, pad], axis=0)
        spec = letterbox_spec(src_hw, self.input_hw)
        t0 = time.perf_counter()
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
            step = self._step_selected if selected else self._step_device_resize
            b, s, c, nv = (t.cpu().numpy() for t in step(x, spec))
        self.last_infer_ms = (time.perf_counter() - t0) * 1e3
        return BatchResult(
            boxes_xyxy=b[:n], scores=s[:n], class_ids=c[:n], num_valid=nv[:n],
        )

    def _predict_group(self, frames_list: Sequence[np.ndarray],
                       shape: Tuple[int, int]) -> BatchResult:
        """Batch-predict same-resolution frames through the cheapest path
        (host pixel pick > host letterbox resize > device letterbox)."""
        spec = letterbox_spec(shape, self.input_hw)
        geom = self._select_geometry(spec) if self.config.host_select != "off" else None
        if geom is not None:
            from ..native import pick_u8, picked_shape

            hr, hoff, wr, woff = geom
            oh, ow = picked_shape(shape[0], shape[1], hr, hoff, wr, woff)
            # pick each frame straight into the batch buffer: one copy
            frames = np.empty((len(frames_list), oh, ow, 3), np.uint8)
            for j, f in enumerate(frames_list):
                pick_u8(f, hr, hoff, wr, woff, out=frames[j])
            return self._predict_prepared(frames, shape, True)
        if self._host_resize_active():
            frames = self._host_resize_packets(list(frames_list), spec)
            if frames is not None:
                return self._predict_prepared(frames, shape, True)
        return self._predict_prepared(np.stack(frames_list), shape, False)

    def predict_packets(self, packets: Sequence[FramePacket]) -> List[List[Detection]]:
        """Batch-predict frame packets; groups by source resolution."""
        by_shape: Dict[Tuple[int, int], List[int]] = {}
        for i, p in enumerate(packets):
            by_shape.setdefault(tuple(p.frame.shape[:2]), []).append(i)
        results: List[List[Detection]] = [[] for _ in packets]
        for shape, idxs in by_shape.items():
            br = self._predict_group([packets[i].frame for i in idxs], shape)
            dets = br.to_detections(
                [packets[i].stream.name for i in idxs],
                [packets[i].frame_id for i in idxs],
            )
            for j, i in enumerate(idxs):
                results[i] = dets[j]
        return results

    def predict(self, packet: FramePacket) -> List[Detection]:
        return self.predict_packets([packet])[0]


def create_detector(config: DetectorConfig) -> BaseDetector:
    """Factory with the reference's routing semantics (detector.py:54-96).
    Only YOLOv8 detection is ported; every other route raises
    NotImplementedError naming ROADMAP.md."""
    if str(config.model_path).endswith(".rvae"):
        raise NotImplementedError("serving .rvae artifacts" + _NOT_PORTED)
    if config.model_type in TEMPORAL_MODEL_TYPES:
        raise NotImplementedError(
            f"temporal model_type {config.model_type!r}" + _NOT_PORTED
        )
    if config.model_type == "resnet":
        raise NotImplementedError("the ResNet classifier" + _NOT_PORTED)
    if config.backend not in ("torch", "cuda"):
        logger.info(
            "backend '%s' requested — serving it with the PyTorch engine",
            config.backend,
        )
    return TorchYoloEngine(config)
