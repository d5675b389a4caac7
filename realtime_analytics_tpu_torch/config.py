"""YAML configuration system.

Schema-compatible with the reference (``src/realtime_analytics/config.py``):
every key accepted by the reference is accepted here with the same meaning,
so existing pipeline YAML files keep working. Additive TPU-specific keys are
documented inline. Two deliberate fixes over the reference:

  * unknown keys are *warned about* instead of silently dropped
    (reference ``config.py:304-307`` silently ignores them — a footgun it
    itself trips on with ``max_frame_rate_per_stream``);
  * ``StreamConfig.batch_size`` is actually honoured: it caps how many
    in-flight frames a stream may have queued at the cross-stream batcher
    (in the reference it is validated but dead, see SURVEY.md §2.15).
"""

from __future__ import annotations

import dataclasses
import logging
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import yaml

logger = logging.getLogger(__name__)


class ConfigError(RuntimeError):
    """Raised when the supplied configuration is invalid."""


# ---------------------------------------------------------------------------
# Section dataclasses
# ---------------------------------------------------------------------------


@dataclass
class FFmpegSimulatorConfig:
    """Spawn an ffmpeg subprocess that serves a looping RTSP stream."""

    enabled: bool = False
    input: str = ""
    loop: bool = True
    listen_host: Optional[str] = None
    log_level: str = "warning"
    video_codec: str = "libx264"
    audio_enabled: bool = False
    audio_codec: str = "aac"
    extra_args: List[str] = field(default_factory=list)

    def validate(self, stream: Optional["StreamConfig"] = None) -> None:
        if not self.enabled:
            return
        if not self.input:
            raise ConfigError("ffmpeg_simulator.input must not be empty when enabled")
        if stream is not None:
            if not stream.url:
                raise ConfigError(
                    f"Stream '{stream.name}' needs a url when ffmpeg_simulator is enabled"
                )
            scheme = stream.url.split(":", 1)[0].lower()
            if scheme != "rtsp":
                raise ConfigError(
                    f"Stream '{stream.name}': ffmpeg_simulator only serves RTSP urls, "
                    f"got scheme '{scheme}'"
                )
        if self.audio_enabled and not self.audio_codec:
            raise ConfigError(
                "ffmpeg_simulator.audio_codec must be set when audio_enabled is true"
            )


@dataclass
class StreamConfig:
    """One RTSP/RTMP/file video stream."""

    name: str = ""
    url: str = ""
    enabled: bool = True
    target_fps: Optional[float] = None
    batch_size: int = 1  # max in-flight frames at the batcher (TPU build makes this live)
    warmup_seconds: float = 2.0
    reconnect_backoff: float = 5.0
    max_retries: Optional[int] = None
    detector_id: Optional[str] = None
    roi_polygons: Optional[List[List[Tuple[int, int]]]] = None
    motion_filter: bool = False
    motion_threshold: float = 0.02
    downsample_ratio: float = 1.0
    adaptive_fps: bool = False
    min_target_fps: float = 5.0
    idle_frame_tolerance: int = 60
    priority: int = 0  # TPU extension: scheduler priority (reference hardcodes 0)
    ffmpeg_simulator: Optional[FFmpegSimulatorConfig] = None

    def __post_init__(self) -> None:
        if isinstance(self.ffmpeg_simulator, dict):
            self.ffmpeg_simulator = _from_dict(
                FFmpegSimulatorConfig, self.ffmpeg_simulator, where="ffmpeg_simulator"
            )
        elif self.ffmpeg_simulator is not None and not isinstance(
            self.ffmpeg_simulator, FFmpegSimulatorConfig
        ):
            # a YAML scalar (e.g. `ffmpeg_simulator: yes`) must get the
            # ConfigError contract, not an AttributeError in validate()
            raise ConfigError(
                f"Stream '{self.name}': ffmpeg_simulator must be a mapping, "
                f"got {type(self.ffmpeg_simulator).__name__}"
            )

    def validate(self) -> None:
        if not self.name:
            raise ConfigError("Stream name must not be empty")
        if not self.url:
            raise ConfigError(f"Stream '{self.name}' must define a non-empty url")
        if self.batch_size < 1:
            raise ConfigError(f"Stream '{self.name}': batch_size must be >= 1")
        if self.target_fps is not None and self.target_fps <= 0:
            raise ConfigError(f"Stream '{self.name}': target_fps must be > 0")
        if self.warmup_seconds < 0:
            raise ConfigError(f"Stream '{self.name}': warmup_seconds must be >= 0")
        if self.reconnect_backoff < 0:
            raise ConfigError(f"Stream '{self.name}': reconnect_backoff must be >= 0")
        if self.max_retries is not None and self.max_retries < 0:
            raise ConfigError(f"Stream '{self.name}': max_retries must be >= 0")
        if self.motion_threshold < 0:
            raise ConfigError(f"Stream '{self.name}': motion_threshold must be >= 0")
        if not (0.1 <= self.downsample_ratio <= 1.0):
            raise ConfigError(
                f"Stream '{self.name}': downsample_ratio must be in [0.1, 1.0]"
            )
        if self.adaptive_fps:
            cap = self.target_fps if self.target_fps is not None else 30.0
            if self.min_target_fps <= 0 or self.min_target_fps > cap:
                raise ConfigError(
                    f"Stream '{self.name}': min_target_fps must be > 0 and <= target_fps"
                )
        if self.roi_polygons is not None:
            for poly in self.roi_polygons:
                if len(poly) < 3:
                    raise ConfigError(
                        f"Stream '{self.name}': ROI polygons need >= 3 points"
                    )
        if self.ffmpeg_simulator and self.ffmpeg_simulator.enabled:
            self.ffmpeg_simulator.validate(self)


VALID_BACKENDS = {
    # Reference backend labels (accepted for YAML compatibility; they all map
    # onto the one JAX engine — reference detector.py:54-96 dispatches to five
    # native runtimes instead).
    "ultralytics",
    "tensorrt",
    "onnx",
    "onnxruntime",
    "openvino",
    "rknn",
    "rk3588",
    # Native labels of the JAX package (one YAML drives both packages) and
    # of this one.
    "jax",
    "tpu",
    "torch",
    "cuda",
}

VALID_MODEL_TYPES = {
    "yolov5",
    "yolov8",
    "resnet",
    "cnn_lstm",
    "3d_cnn",
    "conv_gru",
    "slow_fast",
    "slowfast_r50",
    "mvitv2_s",
}

# slowfast_r50: the published SlowFast R50 8x8 (models/slowfast.py), and
# mvitv2_s: the published MViTv2-S 16x4 (models/mvit.py), which the JAX
# package does not have; slow_fast is the JAX package's small model
TEMPORAL_MODEL_TYPES = {"cnn_lstm", "3d_cnn", "conv_gru", "slow_fast", "slowfast_r50",
                        "mvitv2_s"}
MVIT_CROP_MULTIPLE = 32  # mvitv2_s: the patch stride 4 times three q strides of 2
SLOWFAST_ALPHA = 4  # slowfast_r50's slow pathway takes every 4th of T frames


@dataclass
class DetectorConfig:
    """Detector / classifier / temporal-model configuration.

    Key compatibility: reference ``config.py:107-191``, and the same schema
    as the JAX package, so one YAML file drives both packages. All backend
    labels are accepted but resolve to the single PyTorch engine;
    TensorRT/RKNN-specific knobs are accepted and ignored (with a log) so
    old YAMLs load.
    """

    model_path: str = "yolov8n.pt"
    # auto | cuda | cuda:N | cpu. auto and cuda mean the first card; with no
    # card visible the engine RAISES (it never drops to the CPU). Only
    # "cpu" runs on the CPU (the tests use it).
    device: str = "auto"
    backend: str = "jax"
    model_type: str = "yolov8"
    confidence_threshold: float = 0.5
    iou_threshold: float = 0.45
    classes: Optional[List[int]] = None
    half: bool = False  # bf16 (the reference package's half format too)
    warmup: bool = True
    input_size: Optional[List[int]] = None  # [H, W]
    # Accepted-for-compat, unused by this engine:
    tensorrt_max_workspace_size: int = 1 << 30
    tensorrt_use_fp16: bool = False
    # ResNet classification:
    resnet_num_classes: int = 1000
    resnet_top_k: int = 5
    # "raw" thresholds/reports the raw model output exactly as the reference
    # does (detector.py:954-978: argsort + threshold on the uninterpreted
    # head output), so migrated configs keep their tuned thresholds.
    # "softmax" normalizes to probabilities first.
    resnet_scores: str = "raw"  # raw | softmax
    # Temporal models:
    sequence_length: int = 16
    sequence_stride: int = 1
    temporal_overlap: float = 0.5
    temporal_pooling: str = "avg"  # avg | max | last (TPU build actually applies it)
    action_classes: Optional[List[str]] = None
    num_action_classes: int = 400
    # ---- TPU extensions (additive) ----
    num_classes: int = 80  # detection classes (COCO default)
    max_batch_size: int = 32  # largest device batch bucket
    batch_buckets: Optional[List[int]] = None  # default: powers of two up to max
    max_detections: int = 300  # padded NMS output size per image
    # candidates entering NMS: the IoU matrix is [B, K, K], so K is the
    # quadratic knob; >512 confidence-passing candidates per frame is
    # vanishingly rare at production thresholds (raise for low-conf sweeps)
    pre_nms_topk: int = 512
    precision: str = "bf16"  # bf16 | fp32 | int8
    # Precision for GENERIC ONNX-GRAPH serving (unknown-layout user .onnx
    # files served by models/onnx_torch.py). Independent of `precision`
    # because a foreign graph's numerics are the user's contract: default
    # fp32 matches their ONNX Runtime baseline; "bf16" opts into mixed
    # precision (bf16 conv/matmul operands and outputs, fp32 for
    # norms/softmax/reductions) — the analog of building an FP16 TensorRT
    # engine from a user's fp32 ONNX export (reference detector.py:382-466),
    # at a bf16-level (1e-2 relative) output tolerance.
    graph_precision: str = "fp32"  # fp32 | bf16
    mesh_shape: Optional[List[int]] = None  # e.g. [4, 2] for (dp, tp); None = 1 chip
    # Persistent XLA compile cache of the JAX package. The port compiles no
    # programs (PyTorch runs eagerly; its kernels build once into
    # build/torch_kernels/), so the key is accepted and unused here.
    compile_cache_dir: Optional[str] = "auto"
    # Each pallas_* knob switches the hand-written Hopper counterpart of the
    # reference's Pallas kernel of that name. "auto" = the CUDA kernel on a
    # CUDA tensor and the plain PyTorch version on a CPU tensor; "on" =
    # the same (the plain version is the CPU form of the kernel); "off" =
    # the plain layer-by-layer PyTorch path everywhere.
    # Bilinear letterbox / stretch kernel (B4, csrc/letterbox.cu). YOLO
    # device-resize step: "auto" launches it on the card when the letterbox
    # resizes (the CPU takes the plain preprocess, as the JAX package's auto
    # does off the TPU); "on" always, in its plain form on the CPU. ResNet and temporal device steps: any value but "off"
    # launches it on the card; "off" (and the CPU) takes the JAX package's
    # unrounded bilinear resize.
    pallas_preprocess: str = "auto"  # auto | on | off
    pallas_gather: str = "auto"  # auto | on | off: NMS payload row gather (B1)
    # Fused v8 head decode: DFL softmax expectation + class max/argmax in
    # one kernel (B2, csrc/decode.cu).
    pallas_decode: str = "auto"  # auto | on | off
    # Host-side cv2 letterbox RESIZE for fractional ratios (the reference
    # resizes on host too): upload the resized content instead of the full
    # frame and reuse the lean pad+cast selected step. auto = on for cuda,
    # off for cpu (odd-integer ratios still take the exact pixel-pick path).
    host_resize: str = "auto"  # auto | on | off
    # Space-to-depth early backbone (models/s2d.py): YOLO nodes 0-3 over
    # s2d tensors, exact up to accumulation order, before B3 where both
    # apply. The JAX engine's policy: on = on; auto decides per bucket on a
    # single-chip TPU only, so it is off on cuda and cpu; off = off.
    s2d_backbone: str = "auto"  # auto | on | off
    # Fused P1/P2 stem: YOLO nodes 0+1 in one kernel with the P1 tile in
    # shared memory (B3, csrc/stem.cu). "interpret" is accepted for YAML
    # compatibility and means "on".
    pallas_stem: str = "auto"  # auto | on | off | interpret
    # When the letterbox ratio is an odd integer per axis (1080p->640 is
    # exactly 3x), bilinear resize degenerates to an exact pixel pick — do
    # it on the HOST before upload: H2D bytes drop 8.6x (6 MB -> 0.7 MB per
    # 1080p frame) and the device-side resize disappears. "off" keeps the
    # full-frame device path (e.g. on a host with too few cores).
    host_select: str = "auto"  # auto | off
    # source resolution to pre-compile for when `warmup: true` and a stream's
    # resolution can't be inferred from its URL (synthetic:// encodes it);
    # [H, W], default 1080p
    warmup_source_hw: Optional[List[int]] = None
    # ---- tiled small-object inference (beyond-reference capability) ----
    # SAHI-style slicing: frames larger than the model input are cut into
    # input-sized tiles (pure memcpy, never a resize) that ride the SAME
    # fixed-shape compiled step as whole frames, then per-tile detections
    # merge with a host intersection-over-smaller dedup across tile seams
    # (ops/tiling.py). 8 tiles per 1080p frame at 640² detect at NATIVE
    # resolution; 32 streams x 25 FPS x 8 tiles still fits one chip.
    tiling: bool = False
    tiling_overlap: float = 0.2  # fraction of tile shared between neighbors
    # also run the normal whole-frame letterboxed pass and merge it in, so
    # objects larger than one tile are still detected whole
    tiling_full_frame: bool = True

    def validate(self) -> None:
        if not self.model_path:
            raise ConfigError("Detector model_path must not be empty")
        dev = str(self.device).lower()
        if dev not in {"auto", "cuda", "cpu"} and not re.fullmatch(r"cuda:\d+", dev):
            raise ConfigError(
                "detector.device must be auto | cuda | cuda:N | cpu, got "
                f"{self.device!r}"
            )
        if self.backend not in VALID_BACKENDS:
            raise ConfigError(f"Detector backend must be one of {sorted(VALID_BACKENDS)}")
        # reference TensorRT knobs: accepted for config compatibility,
        # no-ops here (PyTorch's allocator owns device memory; precision
        # comes from `precision`/`half`) — say so instead of silently ignoring
        if self.tensorrt_max_workspace_size != 1 << 30:
            logger.warning(
                "detector.tensorrt_max_workspace_size is a no-op on the "
                "PyTorch engine (its caching allocator manages device memory)"
            )
        if self.tensorrt_use_fp16 and self.precision == "fp32" and not self.half:
            logger.warning(
                "detector.tensorrt_use_fp16 requested with precision: "
                "fp32 — set precision: bf16 (the engine's half format) to get "
                "the fp16-engine behavior"
            )
        if self.model_type not in VALID_MODEL_TYPES:
            raise ConfigError(f"Model type must be one of {sorted(VALID_MODEL_TYPES)}")
        if not (0.0 < self.confidence_threshold <= 1.0):
            raise ConfigError("confidence_threshold must be in (0, 1]")
        if not (0.0 < self.iou_threshold <= 1.0):
            raise ConfigError("iou_threshold must be in (0, 1]")
        if self.input_size is not None and (
            len(self.input_size) != 2 or any(v <= 0 for v in self.input_size)
        ):
            raise ConfigError(
                "input_size must be [height, width] with positive values"
            )
        if (
            self.input_size is not None
            and self.model_type in ("yolov5", "yolov8")
            and any(v % 32 for v in self.input_size)
        ):
            raise ConfigError(
                "YOLO input_size must be divisible by 32 (stride of the P5 "
                "level); got " + str(self.input_size)
            )
        if self.model_type == "resnet":
            if self.resnet_num_classes <= 0:
                raise ConfigError("resnet_num_classes must be > 0")
            if self.resnet_top_k <= 0:
                raise ConfigError("resnet_top_k must be > 0")
            if self.resnet_scores not in {"raw", "softmax"}:
                raise ConfigError("resnet_scores must be 'raw' or 'softmax'")
        if self.model_type in TEMPORAL_MODEL_TYPES:
            if self.sequence_length <= 0:
                raise ConfigError("sequence_length must be > 0 for temporal models")
            if self.sequence_stride <= 0:
                raise ConfigError("sequence_stride must be > 0 for temporal models")
            if not (0.0 <= self.temporal_overlap < 1.0):
                raise ConfigError("temporal_overlap must be in [0, 1)")
            if self.temporal_pooling not in {"avg", "max", "last"}:
                raise ConfigError("temporal_pooling must be one of: avg, max, last")
            if self.num_action_classes <= 0:
                raise ConfigError("num_action_classes must be > 0")
        if self.model_type == "slowfast_r50":
            if self.sequence_length % SLOWFAST_ALPHA:
                raise ConfigError(
                    f"slowfast_r50 needs a sequence_length that is a multiple of "
                    f"alpha = {SLOWFAST_ALPHA} (its slow pathway's frames), got "
                    f"{self.sequence_length}")
            if self.mesh_shape is not None:
                raise ConfigError("slowfast_r50 is served on one device: mesh_shape is not "
                                  "supported for it")
        if self.model_type == "mvitv2_s":
            if self.sequence_length % 2:
                raise ConfigError(
                    "mvitv2_s needs an even sequence_length (its patch embedding strides "
                    f"time by 2), got {self.sequence_length}")
            h, w = self.resolved_input_size
            if h != w or h % MVIT_CROP_MULTIPLE:
                raise ConfigError(
                    f"mvitv2_s needs a square input_size that is a multiple of "
                    f"{MVIT_CROP_MULTIPLE} (its token grids halve three times after the "
                    f"patch stride of 4), got {[h, w]}")
            if self.mesh_shape is not None:
                raise ConfigError("mvitv2_s is served on one device: mesh_shape is not "
                                  "supported for it")
            # on the card every block's attention is B8, which takes bf16
            # alone; auto and cuda never fall back to the CPU (pick_device)
            bf16 = self.precision == "bf16" or (self.precision == "fp32" and self.half)
            if str(self.device).lower() != "cpu" and not bf16:
                raise ConfigError(
                    f"mvitv2_s on a CUDA device runs in bf16 (its attention kernel takes "
                    f"bf16 alone): set precision: bf16, got precision: {self.precision}"
                    f"{' with half' if self.half else ''}")
        if self.max_batch_size < 1:
            raise ConfigError("max_batch_size must be >= 1")
        if self.max_detections < 1:
            raise ConfigError("max_detections must be >= 1")
        if self.host_select not in {"auto", "off"}:
            raise ConfigError("host_select must be 'auto' or 'off'")
        if not (0.0 <= self.tiling_overlap <= 0.8):
            raise ConfigError("tiling_overlap must be in [0, 0.8]")
        if self.precision not in {"bf16", "fp32", "int8"}:
            raise ConfigError("precision must be one of: bf16, fp32, int8")
        if self.graph_precision not in {"fp32", "bf16"}:
            raise ConfigError("graph_precision must be 'fp32' or 'bf16'")
        if self.num_classes <= 0:
            raise ConfigError("num_classes must be > 0")
        if self.pre_nms_topk <= 0:
            raise ConfigError("pre_nms_topk must be > 0")
        if self.warmup_source_hw is not None and (
            len(self.warmup_source_hw) != 2
            or any(v <= 0 for v in self.warmup_source_hw)
        ):
            raise ConfigError(
                "warmup_source_hw must be [height, width] with positive values"
            )
        if self.batch_buckets is not None:
            if not self.batch_buckets or any(b < 1 for b in self.batch_buckets):
                raise ConfigError("batch_buckets entries must be >= 1")
            if max(self.batch_buckets) < self.max_batch_size:
                # serving forms batches up to max_batch_size; sizes above
                # the largest compile bucket would hit UNWARMED jit shapes
                # (multi-second recompiles on the hot path)
                raise ConfigError(
                    f"max(batch_buckets)={max(self.batch_buckets)} must be "
                    f">= max_batch_size={self.max_batch_size} — batches "
                    "above the largest bucket cannot pad into any compiled "
                    "shape"
                )
        if self.mesh_shape is not None and any(m < 1 for m in self.mesh_shape):
            raise ConfigError("mesh_shape entries must be >= 1")
        if self.pallas_preprocess not in {"auto", "on", "off"}:
            raise ConfigError("pallas_preprocess must be auto|on|off")
        if self.pallas_gather not in {"auto", "on", "off"}:
            raise ConfigError("pallas_gather must be auto|on|off")
        if self.s2d_backbone not in {"auto", "on", "off"}:
            raise ConfigError("s2d_backbone must be auto|on|off")
        if self.pallas_decode not in {"auto", "on", "off"}:
            raise ConfigError("pallas_decode must be auto|on|off")
        if self.pallas_stem not in {"auto", "on", "off", "interpret"}:
            raise ConfigError("pallas_stem must be auto|on|off|interpret")
        if self.host_resize not in {"auto", "on", "off"}:
            raise ConfigError("host_resize must be auto|on|off")

    @property
    def resolved_input_size(self) -> Tuple[int, int]:
        if self.input_size:
            return int(self.input_size[0]), int(self.input_size[1])
        if self.model_type in TEMPORAL_MODEL_TYPES:
            return (112, 112) if self.model_type in {"3d_cnn", "slow_fast"} else (224, 224)
        if self.model_type == "resnet":
            return (224, 224)
        return (640, 640)

    @property
    def resolved_buckets(self) -> List[int]:
        if self.batch_buckets:
            return sorted(set(int(b) for b in self.batch_buckets))
        buckets = []
        b = 1
        while b < self.max_batch_size:
            buckets.append(b)
            b *= 2
        buckets.append(self.max_batch_size)
        return sorted(set(buckets))


@dataclass
class TrackerConfig:
    """Tracker configuration.

    ``type``:
      * "byte_track" / "iou" — the reference's IOU tracker contract
        (the reference only *labels* its IOU tracker byte_track,
        tracker.py:38-43; the shim stays default for config parity);
      * "byte_track_full" — genuine ByteTrack: two-stage association
        (high-confidence first, then low-confidence rescue of unmatched
        tracks) with an optional Kalman constant-velocity motion model.
    """

    type: str = "byte_track"
    max_age: int = 30
    max_iou_distance: float = 0.7  # despite the name: minimum IoU to match (ref quirk)
    min_hits: int = 3
    max_tracks_per_stream: int = 256  # TPU extension: padding bound for vectorized assoc
    # ---- byte_track_full knobs (ByteTrack paper defaults) ----
    high_thresh: float = 0.5  # stage-1 detection confidence gate
    low_thresh: float = 0.1  # stage-2 lower confidence bound
    new_track_thresh: float = 0.6  # min confidence to start a track
    match_thresh: float = 0.8  # stage-1 min IoU
    use_kalman: bool = True  # constant-velocity motion model

    def validate(self) -> None:
        if self.type not in {"byte_track", "iou", "byte_track_full"}:
            raise ConfigError(
                "Tracker type must be one of: byte_track, iou, byte_track_full"
            )
        if self.max_age < 1:
            raise ConfigError("Tracker max_age must be >= 1")
        if self.max_iou_distance <= 0:
            raise ConfigError("Tracker max_iou_distance must be > 0")
        if self.min_hits < 0:
            raise ConfigError("Tracker min_hits must be >= 0")
        if self.max_tracks_per_stream < 1:
            raise ConfigError("Tracker max_tracks_per_stream must be >= 1")
        if not (0.0 <= self.low_thresh <= self.high_thresh <= 1.0):
            raise ConfigError("need 0 <= low_thresh <= high_thresh <= 1")
        if not (0.0 < self.match_thresh <= 1.0):
            raise ConfigError("match_thresh must be in (0, 1]")


@dataclass
class KafkaSinkConfig:
    """Event sink configuration (Kafka wire-compatible payloads)."""

    enabled: bool = False
    bootstrap_servers: str = "localhost:9092"
    topic: str = "analytics"
    linger_ms: int = 10
    max_batch_size: int = 16384
    include_frames: bool = False
    frame_quality: int = 75
    # ---- TPU extensions ----
    transport: str = "kafka"  # kafka | eventbus | jsonl | memory
    jsonl_path: Optional[str] = None
    frame_interval_seconds: float = 0.1  # preview rate cap (ref hardcodes 0.1s)

    def validate(self) -> None:
        if self.enabled and not self.topic:
            raise ConfigError("Kafka sink topic must not be empty when enabled")
        if self.linger_ms < 0:
            raise ConfigError("Kafka sink linger_ms must be >= 0")
        if self.max_batch_size <= 0:
            raise ConfigError("Kafka sink max_batch_size must be > 0")
        if not (1 <= self.frame_quality <= 100):
            raise ConfigError("Kafka sink frame_quality must be in [1, 100]")
        if self.transport not in {"kafka", "eventbus", "jsonl", "memory"}:
            raise ConfigError("Kafka sink transport must be kafka|eventbus|jsonl|memory")
        if self.frame_interval_seconds < 0:
            raise ConfigError("frame_interval_seconds must be >= 0")


@dataclass
class PrometheusConfig:
    """Prometheus scrape endpoint configuration."""

    enabled: bool = True
    host: str = "0.0.0.0"
    port: int = 9000
    interval_seconds: float = 5.0

    def validate(self) -> None:
        if not (0 < self.port < 65536):
            raise ConfigError("Prometheus port must be in [1, 65535]")
        if self.interval_seconds <= 0:
            raise ConfigError("Prometheus interval_seconds must be > 0")


@dataclass
class SnapshotConfig:
    """Periodic annotated JPEG snapshots (TPU extension: the reference
    hardcodes /data/outputs and 300 s at pipeline.py:269,282)."""

    enabled: bool = True
    output_dir: str = "/data/outputs"
    interval_seconds: float = 300.0

    def validate(self) -> None:
        if self.interval_seconds <= 0:
            raise ConfigError("Snapshot interval_seconds must be > 0")


@dataclass
class PipelineConfig:
    """Top-level pipeline configuration."""

    streams: List[StreamConfig] = field(default_factory=list)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    detectors: Dict[str, DetectorConfig] = field(default_factory=dict)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    kafka: KafkaSinkConfig = field(default_factory=KafkaSinkConfig)
    prometheus: PrometheusConfig = field(default_factory=PrometheusConfig)
    snapshots: SnapshotConfig = field(default_factory=SnapshotConfig)
    max_concurrent_streams: int = 32
    stats_interval_seconds: float = 15.0  # live here: drives scheduler status logs
    batch_window_ms: float = 4.0  # TPU extension: batcher packing window
    batch_pipeline_depth: int = 2  # TPU extension: in-flight batches (H2D/compute overlap)
    # TPU extension: temporal clip coalescing window. Clips that become
    # ready (per-stream ring buffer filled) within this window run as ONE
    # device clip batch even when their frames arrived in different batcher
    # ticks. 0 = reference-like arrival grouping. Temporal clips are the
    # expensive device calls (8-30x a single-frame detect), so coalescing
    # drifted streams into one batch is worth a bounded wait; keep the
    # window under frame_interval * (stream.batch_size - 1) to avoid
    # stalling stream workers.
    temporal_clip_window_ms: float = 0.0

    def validate(self) -> None:
        if not self.streams:
            raise ConfigError("At least one stream must be configured")
        if self.max_concurrent_streams < 1:
            raise ConfigError("max_concurrent_streams must be >= 1")
        if len(self.streams) > self.max_concurrent_streams:
            raise ConfigError(
                f"Configured {len(self.streams)} streams but "
                f"max_concurrent_streams={self.max_concurrent_streams}"
            )
        if self.stats_interval_seconds <= 0:
            raise ConfigError("stats_interval_seconds must be > 0")
        if self.batch_window_ms < 0:
            raise ConfigError("batch_window_ms must be >= 0")
        if self.batch_pipeline_depth < 1:
            raise ConfigError("batch_pipeline_depth must be >= 1")
        if self.temporal_clip_window_ms < 0:
            raise ConfigError("temporal_clip_window_ms must be >= 0")
        names = [s.name for s in self.streams]
        if len(set(names)) != len(names):
            raise ConfigError("Stream names must be unique")
        for stream in self.streams:
            if stream.detector_id and stream.detector_id not in self.detectors:
                raise ConfigError(
                    f"Stream '{stream.name}' references unknown "
                    f"detector_id='{stream.detector_id}'"
                )
            stream.validate()
        self.detector.validate()
        for det in self.detectors.values():
            det.validate()
        self.tracker.validate()
        self.kafka.validate()
        self.prometheus.validate()
        self.snapshots.validate()


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------


def _from_dict(cls, data: dict, where: str = ""):
    """Build a dataclass from a dict, warning on unknown keys."""
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise ConfigError(f"Section '{where or cls.__name__}' must be a mapping")
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - known
    if unknown:
        logger.warning(
            "Ignoring unknown config keys in %s: %s",
            where or cls.__name__,
            ", ".join(sorted(unknown)),
        )
    return cls(**{k: v for k, v in data.items() if k in known})


def load_config(path: Union[Path, str]) -> PipelineConfig:
    """Load and validate a pipeline configuration from a YAML file."""
    config_path = Path(path)
    if not config_path.exists():
        raise ConfigError(f"Configuration file not found: {config_path}")

    raw = yaml.safe_load(config_path.read_text(encoding="utf-8"))
    if not isinstance(raw, dict):
        raise ConfigError("Top level configuration must be a mapping")
    return config_from_dict(raw)


def config_from_dict(raw: dict) -> PipelineConfig:
    """Build a validated PipelineConfig from an already-parsed mapping."""
    stream_dicts = raw.get("streams")
    if not isinstance(stream_dicts, list):
        raise ConfigError("'streams' must be a list in the configuration")

    streams = [
        _from_dict(StreamConfig, sd, where=f"streams[{i}]")
        for i, sd in enumerate(stream_dicts)
    ]
    detector = _from_dict(DetectorConfig, raw.get("detector", {}), where="detector")
    detectors_raw = raw.get("detectors", {}) or {}
    if not isinstance(detectors_raw, dict):
        raise ConfigError("'detectors' section must be a mapping of id -> config")
    detectors = {
        key: _from_dict(DetectorConfig, value or {}, where=f"detectors.{key}")
        for key, value in detectors_raw.items()
    }
    pipeline = PipelineConfig(
        streams=streams,
        detector=detector,
        detectors=detectors,
        tracker=_from_dict(TrackerConfig, raw.get("tracker", {}), where="tracker"),
        kafka=_from_dict(KafkaSinkConfig, raw.get("kafka", {}), where="kafka"),
        prometheus=_from_dict(
            PrometheusConfig, raw.get("prometheus", {}), where="prometheus"
        ),
        snapshots=_from_dict(
            SnapshotConfig, raw.get("snapshots", {}), where="snapshots"
        ),
        max_concurrent_streams=raw.get("max_concurrent_streams", 32),
        stats_interval_seconds=raw.get("stats_interval_seconds", 15.0),
        batch_window_ms=raw.get("batch_window_ms", 4.0),
        batch_pipeline_depth=raw.get("batch_pipeline_depth", 2),
        temporal_clip_window_ms=raw.get("temporal_clip_window_ms", 0.0),
    )
    known_top = {
        "streams", "detector", "detectors", "tracker", "kafka", "prometheus",
        "snapshots", "max_concurrent_streams", "stats_interval_seconds",
        "batch_window_ms", "batch_pipeline_depth", "temporal_clip_window_ms",
    }
    unknown_top = set(raw) - known_top
    if unknown_top:
        logger.warning(
            "Ignoring unknown top-level config keys: %s", ", ".join(sorted(unknown_top))
        )
    pipeline.validate()
    return pipeline
