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
224x224; 3D-CNN/SlowFast use mean/std 0.45/0.225 at 112x112, and
``slowfast_r50`` (the published SlowFast R50 8x8, ``models/slowfast.py``;
T a multiple of 4, as PySlowFast's 32 frames at stride 2) the same at
224x224, as does ``mvitv2_s`` (the published MViTv2-S 16x4,
``models/mvit.py``; an even T, as its 16 frames at stride 4, and a square
crop that is a multiple of 32). With
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

Tracing (``telemetry/spans.py``; on while a profiler records): a
``predict_clips`` or ``predict_packets`` call is an engine batch
(``spans.engine_batch``) holding, per group of frame shape, a
``clip_pack`` span (the host assembles the clips: one native gather of
every frame, a stack, or host resize, and the padding to the bucket) and
a ``clip_step`` span (the upload, the forward, the top-5 and logits coming
back). ``stats`` (``ClipStats``) counts calls, clips, the clips' frames
packed on the host, those the native gather copied and the bytes
uploaded, always, the model's convs run as stacked 2D convs
(``models/slowfast.py``) and its attentions run on B8 (``models/mvit.py``).
``predict_clips(..., return_logits=True)`` also returns the fp32 logits
the step computed, clip by clip.

The pack writes a call's clips into the engine's reused staging buffers
(``ClipStaging``), pinned on the card up to ``PIN_BYTES`` an engine.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ConfigError, DetectorConfig
from ..models.mvit import fused_attentions
from ..models.onnx_graph_model import graph_dtype, load_graph_fallback
from ..models.resnet import IMAGENET_MEAN, IMAGENET_STD
from ..models.slowfast import stacked_convs
from ..models.temporal import build_temporal
from ..models.weights import (
    load_temporal_checkpoint,
    temporal_params_from_jax,
    temporal_synthetic_params,
)
from ..native import frames as native_frames
from ..ops.letterbox import stretch_spec
from ..telemetry import spans
from ..types import Detection, FramePacket, TemporalDetection
from .detector import (
    BaseDetector,
    PreparedState,
    bgr_unit_rgb,
    by_frame_shape,
    compute_dtype_of,
    cv2_stretch,
    fp32_means_fp32,
    pick_device,
    stretch_unit_rgb,
    to_graph_device,
)

logger = logging.getLogger(__name__)

TOP_K = 5  # reference emits top-5 actions per clip
# mean/std 0.45/0.225 (Kinetics, PySlowFast's DATA.MEAN/STD)
NORM_045 = ("3d_cnn", "slow_fast", "slowfast_r50", "mvitv2_s")
PIN_BYTES = 256 << 20  # an engine's staging buffers pinned in host memory, at most


@dataclass
class ClipStats:
    """The engine's counters: ``predict_clips`` calls, clips served (no
    padding), their frames packed on the host (clips x T), the frames the
    pack's native gather copied (padding included; 0 where the pack stacks
    with numpy or resizes), and the bytes of the clip arrays uploaded
    (padding included); ``stacked_convs``, the model's convs run as 2D convs
    over stacked frames so far, warmup included (``models/slowfast.py``: the
    two stems a step on the card); ``fused_attentions``, the model's block
    attentions run on B8 so far, warmup included (``models/mvit.py``: every
    block a step on the card)."""

    calls: int = 0
    clips: int = 0
    frames_packed: int = 0
    frames_gathered: int = 0
    bytes_uploaded: int = 0
    stacked_convs: int = 0
    fused_attentions: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def add(self, calls: int = 0, clips: int = 0, frames: int = 0, nbytes: int = 0,
            gathered: int = 0) -> None:
        with self._lock:
            self.calls += calls
            self.clips += clips
            self.frames_packed += frames
            self.frames_gathered += gathered
            self.bytes_uploaded += nbytes


class ClipStaging:
    """An engine's reusable uint8 clip buffers, [clips, T, h, w, 3]. A call
    takes one for its packed clips and gives it back after its step, so a
    call neither allocates nor faults in a fresh batch: ``take`` hands out
    the smallest free buffer of the frame shape with room for the clips;
    where none has room, or the frame shape differs, it releases the free
    ones and makes a new one. So the buffers kept are of one frame shape,
    no more than the calls that ran at once. On the card up to
    ``PIN_BYTES`` of them in all are pinned, so their upload is one DMA the
    host does not copy through; the rest (full-frame clips) are pageable.
    Concurrent calls (the batcher runs several) each hold their own."""

    def __init__(self, pin: bool):
        self._pin = pin
        self._lock = threading.Lock()
        self._shape: Optional[Tuple[int, ...]] = None  # the frame shape of the buffers kept
        self._free: List[torch.Tensor] = []
        self.pinned_bytes = 0

    def take(self, clips: int, shape: Tuple[int, ...]) -> torch.Tensor:
        with self._lock:
            fits = [k for k, buf in enumerate(self._free) if buf.shape[0] >= clips]
            if fits and shape == self._shape:
                return self._free.pop(min(fits, key=lambda k: self._free[k].shape[0]))
            for buf in self._free:
                self._drop(buf)
            self._free, self._shape = [], shape
            nbytes = clips * int(np.prod(shape))
            pinned = self._pin and self.pinned_bytes + nbytes <= PIN_BYTES
            self.pinned_bytes += nbytes if pinned else 0
        return torch.empty((clips, *shape), dtype=torch.uint8, pin_memory=pinned)

    def give(self, buf: torch.Tensor) -> None:
        with self._lock:
            if tuple(buf.shape[1:]) == self._shape:
                self._free.append(buf)
            else:
                self._drop(buf)

    def _drop(self, buf: torch.Tensor) -> None:
        if self._pin and buf.is_pinned():
            self.pinned_bytes -= buf.numel()


class TorchTemporalEngine(PreparedState, BaseDetector):
    """CNN-LSTM / 3D-CNN / ConvGRU / SlowFast / MViT engine."""

    _step_span = "clip_step"

    def __init__(self, config: DetectorConfig, params: Optional[Dict] = None,
                 devices: Optional[Sequence] = None):
        """``devices``: the mesh's devices under ``mesh_shape`` (see
        ``BaseDetector._init_mesh``)."""
        config.validate()
        self.config = config
        self.device = pick_device(config)
        fp32_means_fp32(self.device)
        self.input_hw: Tuple[int, int] = config.resolved_input_size
        self.model = build_temporal(
            config.model_type, config.num_action_classes, config.temporal_pooling,
            t_len=config.sequence_length, crop=self.input_hw[0],
        )
        self.compute_dtype = compute_dtype_of(config)
        if config.model_type in NORM_045:
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
        self._init_steps()
        self._warned_no_cv2 = False
        self.stats = ClipStats()
        self._staging = ClipStaging(self.device.type == "cuda")
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

    def _host_prepares(self, src_hw) -> bool:
        """Whether clips of ``src_hw`` frames are stretched on the host."""
        return tuple(src_hw) != tuple(self.input_hw) and self._host_resize_active()

    def _pack(self, sequences, idxs, src_hw, bucket: int) -> Tuple[torch.Tensor, bool]:
        """(buffer, resized): the group's clips in a staging buffer
        (``ClipStaging.take``; the step reads its first ``bucket``), as
        uint8 [T, h, w, 3] each, stretched frame by frame (cv2) on the host
        when ``_host_prepares``, else copied as they are, padded by
        repeating the last: every frame of the bucket in one native call
        (``native.frames.gather``, counted in ``stats.frames_gathered``)
        where the frames allow it, else a numpy stack a clip. The caller
        gives the buffer back after the step."""
        n, t_len = len(idxs), self.config.sequence_length
        resized = self._host_prepares(src_hw)
        hw = tuple(self.input_hw) if resized else tuple(src_hw)
        buf = self._staging.take(bucket, (t_len, *hw, 3))
        out = buf.numpy()[:bucket]
        if not resized:
            order = [*idxs, *[idxs[-1]] * (bucket - n)]
            if native_frames.gather([p.frame for i in order for p in sequences[i]],
                                    out.reshape(bucket * t_len, *hw, 3)):
                self.stats.add(gathered=bucket * t_len)
                return buf, resized
        for j, i in enumerate(idxs):
            frames = [p.frame for p in sequences[i]]
            if resized:
                cv2_stretch(frames, hw, out=out[j])
            else:
                np.stack(frames, out=out[j])
        out[n:] = out[n - 1]
        return buf, resized

    def _clip_head(self, x: torch.Tensor, b: int, logits: bool = False):
        """x: [B*T, th, tw, 3] fp32 RGB in [0, 1] -> softmax top-5 (scores,
        classes), and the fp32 logits when ``logits``."""
        th, tw = self.input_hw
        x = ((x - self._mean) / self._std).to(self.compute_dtype)
        x = x.reshape(b, self.config.sequence_length, th, tw, 3)
        out = self.net(x).to(torch.float32)
        self.stats.stacked_convs = stacked_convs(self.model)
        self.stats.fused_attentions = fused_attentions(self.model)
        probs = torch.softmax(out, dim=-1)
        scores, classes = torch.topk(probs, min(TOP_K, probs.shape[-1]), dim=-1)
        return (scores, classes, out) if logits else (scores, classes)

    def _step(self, clips_u8: torch.Tensor, resized: bool, logits: bool = False):
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
        return self._clip_head(x, b, logits)

    def _step_key(self, batch: int, src_hw: Tuple[int, int], resized: bool,
                  logits: bool = False):
        """JAX's keys, and the port's logits variant tagged."""
        key = super()._step_key(batch, src_hw, resized)
        return (*key, "logits") if logits else key

    def _step_fn(self, key):
        resized, logits = key[1] == "rsz", key[-1] == "logits"
        hw = self.input_hw if resized else key[1:3]
        # an exported step has no logits output
        fn = ((lambda x: self._step(x, resized, True)) if logits
              else (lambda x: self._step(x, resized)))
        return fn, (key[0], self.config.sequence_length, *hw, 3)

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
        with spans.engine_batch():
            return self._predict_packets(packets)

    def _predict_packets(self, packets: Sequence[FramePacket]) -> List[List[Detection]]:
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

    def predict_clips(self, sequences: Sequence[List[FramePacket]],
                      return_logits: bool = False):
        """Batched inference over ready clips, grouped by frame shape (the
        batcher's clip-coalescing path calls this directly). Returns each
        clip's detections and, with ``return_logits``, also the fp32 logits
        [clips, classes] the step computed for them."""
        with spans.engine_batch():
            return self._predict_clips(sequences, return_logits)

    def _predict_clips(self, sequences, return_logits: bool):
        results: List[List[Detection]] = [[] for _ in sequences]
        logits = [None] * len(sequences)
        t_len = self.config.sequence_length
        for shape, idxs in by_frame_shape(seq[0].frame for seq in sequences).items():
            n = len(idxs)
            # more clips than the largest bucket run unpadded, as in JAX
            bucket = max(n, self._effective_bucket(n, shape))
            with spans.span("clip_pack"):
                buf, resized = self._pack(sequences, idxs, shape, bucket)
            clips = buf[:bucket]
            try:
                out = self._run_step(self._step_key(bucket, shape, resized, return_logits),
                                     clips)
            finally:
                self._staging.give(buf)
            self.stats.add(clips=n, frames=n * t_len, nbytes=clips.nbytes)
            for j, i in enumerate(idxs):
                results[i] = self._to_detections(sequences[i], out[0][j], out[1][j])
                if return_logits:
                    logits[i] = out[2][j]
        self.stats.add(calls=1)
        if return_logits:
            return results, (np.stack(logits) if logits else
                             np.zeros((0, self.config.num_action_classes), np.float32))
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
