"""Temporal detection engine: sliding-window clip inference on PyTorch.

Counterpart of ``realtime_analytics_tpu/engine/temporal.py``
(``JaxTemporalEngine``), with the reference's buffering contract
(temporal_detector.py:50-147):

  * per-stream ring buffer of ``sequence_length * sequence_stride`` frames;
  * a clip is the strided sample ``buffer[i * stride] for i in range(T)``;
  * after inference, ``required - step`` frames are retained for overlap,
    where ``step = max(1, int(T * (1 - temporal_overlap)))``;
  * a change of frame shape restarts the stream's window;
  * results are ``TemporalDetection``s: top-5 action classes over the clip
    (softmax), full-frame boxes, clip start/end frame ids.

Preprocessing per family: CNN-LSTM/ConvGRU use ImageNet mean/std at
224x224; 3D-CNN/SlowFast use mean/std 0.45/0.225 at 112x112. With
``host_resize`` active (auto = on for the card, and it needs cv2) the clip
frames are stretched on the host; otherwise the device step stretches the
full frames: kernel B4 on the card unless ``pallas_preprocess: off``, else
the JAX package's unrounded bilinear resize.

A ``.onnx`` clip model that matches no known layout is served as its own
graph (``models/onnx_graph_model.py``) in the same clip step.

``detector.mesh_shape: [dp, tp]`` serves the clip step over an in-process
mesh, as the JAX engine does (``BaseDetector._init_mesh``): clip buckets
round up to a multiple of dp, the clips split over dp (B4 once per dp
shard of their frames), conv and dense channels over tp (graphs: dp only).
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ConfigError, DetectorConfig
from ..models.onnx_graph_model import graph_dtype, load_graph_fallback
from ..models.resnet import IMAGENET_MEAN, IMAGENET_STD
from ..models.temporal import build_temporal
from ..models.weights import (
    load_temporal_checkpoint,
    temporal_params_from_jax,
    temporal_synthetic_params,
)
from ..ops.letterbox import stretch_spec
from ..types import Detection, FramePacket, TemporalDetection
from .detector import (
    BaseDetector,
    PreparedState,
    _cheapest_bucket,
    bgr_unit_rgb,
    compute_dtype_of,
    cv2_stretch,
    fp32_means_fp32,
    pick_device,
    stretch_unit_rgb,
    to_graph_device,
)

logger = logging.getLogger(__name__)

TOP_K = 5  # reference emits top-5 actions per clip


class TorchTemporalEngine(PreparedState, BaseDetector):
    """CNN-LSTM / 3D-CNN / ConvGRU / SlowFast engine."""

    def __init__(self, config: DetectorConfig, params: Optional[Dict] = None,
                 devices: Optional[Sequence] = None):
        """``devices``: the mesh's devices under ``mesh_shape`` (see
        ``BaseDetector._init_mesh``)."""
        config.validate()
        self.config = config
        self.device = pick_device(config)
        fp32_means_fp32(self.device)
        self.model = build_temporal(
            config.model_type, config.num_action_classes, config.temporal_pooling
        )
        self.input_hw: Tuple[int, int] = config.resolved_input_size
        self.compute_dtype = compute_dtype_of(config)
        if config.model_type in ("3d_cnn", "slow_fast"):
            mean, std = (0.45, 0.45, 0.45), (0.225, 0.225, 0.225)
        else:
            mean, std = IMAGENET_MEAN, IMAGENET_STD
        self._mean = torch.tensor(mean, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(std, dtype=torch.float32, device=self.device)
        if params is None:
            params = load_temporal_checkpoint(self.model, config.model_path)
        graph = None
        if params is None:  # a clip graph (reference temporal_detector.py:179-319)
            graph = load_graph_fallback(
                config.model_path, "temporal", model_type=config.model_type,
                t_len=config.sequence_length, input_hw=tuple(self.input_hw),
                compute_dtype=graph_dtype(config.graph_precision))
        if graph is not None:
            self.model, self.compute_dtype = graph, graph.compute_dtype
            to_graph_device(graph, self.device)
        else:
            if params is None:
                logger.warning(
                    "No loadable temporal weights at '%s' — using seeded random "
                    "weights (seed 0).", config.model_path,
                )
                params = temporal_synthetic_params(self.model, seed=0)
            temporal_params_from_jax(self.model, params)
            self.model.to(device=self.device, dtype=self.compute_dtype).eval()
        self.sequence_step = max(
            1, int(config.sequence_length * (1.0 - config.temporal_overlap))
        )
        self._buffers: Dict[str, Deque[FramePacket]] = {}
        self._bucket_cost_ms: Dict[Tuple[int, int], Dict[int, float]] = {}
        self._warned_no_cv2 = False
        self.last_infer_ms = 0.0
        self._operands = {}
        # multi-device: [dp, tp] shards channels over tp, clip batches over
        # dp (temporal graphs: dp only)
        self._init_mesh(devices)

    # -- prepared state (engine/export.py) -------------------------------------

    def _operands_spec(self, src_hw):
        return stretch_spec(src_hw, self.input_hw), torch.float32

    def _own_state(self) -> Dict:
        """The family's normalisation."""
        return {"mean": self._mean, "std": self._std}

    def _bind_own(self, state: Dict) -> None:
        self._mean, self._std = state["mean"], state["std"]

    # -- clip step -----------------------------------------------------------

    def _host_resize_active(self) -> bool:
        """Stretch clip frames on the host (cv2) before upload. auto = on
        for the card. Warmup and predict take the same decision; without
        cv2, ``on`` raises and ``auto`` warns once and stays off."""
        if self.config.host_resize == "off":
            return False
        if self.config.host_resize == "auto" and self.device.type != "cuda":
            return False
        try:
            import cv2  # noqa: F401
        except ImportError:
            if self.config.host_resize == "on":
                raise ConfigError(
                    "host_resize: on requires cv2, which is not importable — "
                    "install opencv or set host_resize to auto/off"
                ) from None
            if not self._warned_no_cv2:
                self._warned_no_cv2 = True
                logger.warning(
                    "host_resize: auto requested but cv2 is unavailable — "
                    "the device clip step resizes the full frames"
                )
            return False
        return True

    def _host_resize_clips(self, sequences, idxs, src_hw) -> Optional[np.ndarray]:
        """[B, T, th, tw, 3] uint8 clips, stretched frame by frame on the
        host straight into the batch buffer. None when inactive or a
        no-op."""
        th, tw = self.input_hw
        if tuple(src_hw) == (th, tw) or not self._host_resize_active():
            return None
        t_len = self.config.sequence_length
        out = np.empty((len(idxs), t_len, th, tw, 3), dtype=np.uint8)
        for j, i in enumerate(idxs):
            cv2_stretch([p.frame for p in sequences[i]], (th, tw), out=out[j])
        return out

    def _clip_head(self, x: torch.Tensor, b: int):
        """x: [B*T, th, tw, 3] fp32 RGB in [0, 1] -> softmax top-5."""
        th, tw = self.input_hw
        x = ((x - self._mean) / self._std).to(self.compute_dtype)
        x = x.reshape(b, self.config.sequence_length, th, tw, 3)
        logits = self.net(x).to(torch.float32)
        probs = torch.softmax(logits, dim=-1)
        return torch.topk(probs, min(TOP_K, probs.shape[-1]), dim=-1)

    def _step(self, clips_u8: torch.Tensor, resized: bool):
        """clips_u8: [B, T, H, W, 3] uint8 BGR (H, W = input size when
        ``resized``)."""
        b, t_len = clips_u8.shape[:2]
        flat = clips_u8.reshape(b * t_len, *clips_u8.shape[2:])
        if resized:
            x = bgr_unit_rgb(flat)
        else:
            kernel = self.config.pallas_preprocess != "off" and self.device.type == "cuda"
            x = stretch_unit_rgb(flat, self.input_hw, kernel,
                                 self.operands_for(flat.shape[1:3]) if kernel else None,
                                 self.mesh)
        return self._clip_head(x, b)

    def _run_bucket(self, bucket: int, clips: np.ndarray, resized: bool):
        """Pad to ``bucket`` clips (repeating the last), run the step, bring
        the top-5 back."""
        n = clips.shape[0]
        if n < bucket:
            clips = np.concatenate([clips, np.repeat(clips[-1:], bucket - n, axis=0)])
        t0 = time.perf_counter()
        with torch.inference_mode():
            scores, classes = self._mesh_call(self._step, clips, resized)
            scores, classes = scores.cpu().numpy(), classes.cpu().numpy()
        self.last_infer_ms = (time.perf_counter() - t0) * 1e3
        return scores[:n], classes[:n]

    def warmup(self, src_hw: Tuple[int, int], buckets=None) -> None:
        """Run the clip step once per bucket, then time it (min of 3), on
        the input ``predict_clips`` will upload."""
        buckets = buckets or self.config.resolved_buckets
        t_len = self.config.sequence_length
        th, tw = self.input_hw
        resized = self._host_resize_active() and tuple(src_hw) != (th, tw)
        hw = (th, tw) if resized else tuple(src_hw)
        costs = self._bucket_cost_ms.setdefault(tuple(src_hw), {})
        for b in buckets:
            rb = self._round_mesh(b)
            clips = np.zeros((rb, t_len, *hw, 3), np.uint8)
            self._run_bucket(rb, clips, resized)
            cost = float("inf")
            for _ in range(3):
                self._run_bucket(rb, clips, resized)
                cost = min(cost, self.last_infer_ms)
            costs[b] = cost
            logger.info("temporal warmup: bucket B=%d src=%s (host_resize=%s) step=%.1fms",
                        rb, src_hw, resized, cost)

    # -- sliding-window predict ----------------------------------------------

    def buffer_packet(self, packet: FramePacket) -> Optional[List[FramePacket]]:
        """Append to the stream's ring buffer; return a clip when one is due.
        Public so the batcher can split buffering (host, per frame) from
        clip inference and coalesce ready clips across streams."""
        cfg = self.config
        name = packet.stream.name
        required = cfg.sequence_length * cfg.sequence_stride
        buf = self._buffers.get(name)
        if buf is None:
            buf = deque(maxlen=required)
            self._buffers[name] = buf
        if buf and buf[-1].frame.shape != packet.frame.shape:
            # a resolution change without a reconnect: a mixed-shape clip
            # cannot stack, so the window restarts
            logger.info(
                "Stream '%s': frame shape changed %s -> %s; clip buffer "
                "reset", name, buf[-1].frame.shape, packet.frame.shape,
            )
            buf.clear()
        buf.append(packet)
        if len(buf) < required:
            return None
        sequence = [buf[i * cfg.sequence_stride] for i in range(cfg.sequence_length)]
        frames_to_keep = max(0, required - self.sequence_step)
        if frames_to_keep > 0:
            self._buffers[name] = deque(list(buf)[-frames_to_keep:], maxlen=required)
        else:
            buf.clear()
        return sequence

    def predict(self, packet: FramePacket) -> List[Detection]:
        sequence = self.buffer_packet(packet)
        if sequence is None:
            return []
        return self.predict_clips([sequence])[0]

    def predict_packets(self, packets: Sequence[FramePacket]) -> List[List[Detection]]:
        """Buffer every packet; the clips that become ready run as one
        clip batch."""
        results: List[List[Detection]] = [[] for _ in packets]
        ready: List[Tuple[int, List[FramePacket]]] = []
        for i, p in enumerate(packets):
            seq = self.buffer_packet(p)
            if seq is not None:
                ready.append((i, seq))
        if ready:
            dets = self.predict_clips([s for _, s in ready])
            for (i, _), d in zip(ready, dets):
                results[i] = d
        return results

    def reset_stream(self, stream_name: str) -> None:
        """Clear the clip buffer (after a reconnect: a clip must not
        straddle a stream gap)."""
        self._buffers.pop(stream_name, None)

    def buffered(self, stream_name: str) -> int:
        """Frames buffered for the stream (the temporal buffer gauge)."""
        buf = self._buffers.get(stream_name)
        return len(buf) if buf else 0

    def predict_clips(self, sequences: Sequence[List[FramePacket]]) -> List[List[Detection]]:
        """Batched inference over ready clips, grouped by frame shape (the
        batcher's clip-coalescing path calls this directly)."""
        by_shape: Dict[Tuple[int, int], List[int]] = {}
        for i, seq in enumerate(sequences):
            by_shape.setdefault(tuple(seq[0].frame.shape[:2]), []).append(i)
        results: List[List[Detection]] = [[] for _ in sequences]
        buckets = self.config.resolved_buckets
        for shape, idxs in by_shape.items():
            clips = self._host_resize_clips(sequences, idxs, shape)
            resized = clips is not None
            if not resized:
                clips = np.stack([np.stack([p.frame for p in sequences[i]]) for i in idxs])
            # more clips than the largest bucket run unpadded, as in JAX
            bucket = self._round_mesh(_cheapest_bucket(buckets, clips.shape[0],
                                                       self._bucket_cost_ms.get(shape, {})))
            scores, classes = self._run_bucket(bucket, clips, resized)
            for j, i in enumerate(idxs):
                results[i] = self._to_detections(sequences[i], scores[j], classes[j])
        return results

    def _to_detections(self, sequence: List[FramePacket], scores: np.ndarray,
                       classes: np.ndarray) -> List[Detection]:
        cfg = self.config
        last = sequence[-1]
        h, w = last.frame.shape[:2]
        names = cfg.action_classes or []
        dets: List[Detection] = []
        for conf, cid in zip(scores.tolist(), classes.tolist()):
            if conf < cfg.confidence_threshold:
                continue
            label = names[cid] if cid < len(names) else f"action_{cid}"
            dets.append(TemporalDetection(
                stream_name=last.stream.name, frame_id=last.frame_id, class_id=int(cid),
                confidence=float(conf), bbox_xyxy=(0.0, 0.0, float(w), float(h)),
                action_label=label, temporal_score=float(conf),
                sequence_start_frame=sequence[0].frame_id,
                sequence_end_frame=last.frame_id,
            ))
        return dets
