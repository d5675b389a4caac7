"""Detection and classification engines on PyTorch.

Counterpart of ``realtime_analytics_tpu/engine/detector.py``:
``TorchYoloEngine`` (``JaxYoloEngine``), ``TorchResNetEngine``
(``JaxResNetEngine``) and ``create_detector``, which also routes the
temporal model types to ``engine/temporal.py``. The YOLO chain per batch is
the same as the JAX package's:

    uint8 NHWC batch -> (host pixel pick) -> pad + cast on the card
        -> YOLOv8 forward (BGR->RGB and /255 folded into the stem weights)
        -> confidence/class masking -> batched NMS -> un-letterbox

and, when no host pick or host resize applies, the device-resize step:
full frames -> letterbox on the card (kernel B4) -> forward -> NMS.

The YOLO engine serves YOLOv5 and YOLOv8, ``precision: int8`` (int8
weights and activations, static scales calibrated at start-up on the
engine's device) and ``tiling: true`` (SAHI-style tiles at native
resolution through the same selected step, merged on the host).

A ``.rvae`` serving artifact (``engine/export.py``) is served by the
exported engine of its family, from the file alone.

The neck is fused on the card (``fuse_neck_on``), as the JAX package's
forward fuses it: the block after each upsample + concat takes the two
inputs through split 1x1 convs (``models/yolo.py``).

Multi-device: ``detector.mesh_shape: [dp, tp]`` serves every engine family
over an in-process (dp, tp) mesh (``parallel/mesh.py``), as the JAX engines
shard their params over a mesh: ``_init_mesh`` builds the mesh (the cards
``cuda:0..n-1``; dp x tp entries of the CPU for ``device: cpu``; or the
``devices=`` an engine is given, which may name one card k times) and the
model over it (``ShardedModel``: conv channels over tp, the batch over dp);
buckets round up to a multiple of dp (``_round_mesh``); the kernels B1, B4
and B6 run once per dp shard, B2 on each shard's joined head, and B3 is off
(its stem weights are tp-sharded), as the JAX engine turns its stem kernel
off under a mesh. Graph-backed models take dp-only meshes.

A ``.onnx`` file that matches no known checkpoint layout but holds a full
graph is served as that graph (``models/onnx_graph_model.py``), as the
reference's ONNX Runtime backend serves any export, in fp32 unless
``graph_precision: bf16``. The YOLO engine then takes no host pick or host
resize (a foreign graph has no stem to fold BGR and /255 into): full
frames go through the device letterbox (kernel B4 on the card) into the
graph; an end-to-end export (NMS inside the graph) takes a confidence
top-k instead of the engine's NMS. The ResNet engine (and the temporal
one) serve a classifier (clip) graph in their usual steps.

A step is prepared once per key and reused, as the JAX engine's ``_steps``
holds one ``jax.jit`` program per (batch bucket x source resolution): every
family keeps its steps in ``_steps`` under JAX's keys at the key's first
use (``warmup`` runs every bucket it times; ``BaseDetector``). A YOLO
step, keyed ``(B, H, W, "sel")`` or ``(B, H, W)``, is on the card the eager
step (``_step_selected`` / ``_step_device_resize``, a closure over the
static letterbox geometry) captured as a CUDA graph and replayed from then
on (``engine/graphs.py``); on the CPU, under a mesh and on a graph-backed
engine it is the eager step itself, as the ResNet and temporal steps are
everywhere. ``step_for`` hands a batch's step to a caller outside the
engine. The step holds no host wait (NMS's
keep pass is kernel B6 on the card; the un-letterbox takes its geometry
as numbers), so ``engine/export.py`` also traces it into one
``torch.export`` program per shape. What a step reads besides the model's
weights, prepared once, is the engine's ``prepared_state``; the exporter
traces the step of a copy ``bind``-ed to a program's inputs.

Device rules: ``device: auto | cuda | cuda:N`` means the card and RAISES
when none is visible; only ``device: cpu`` runs on the CPU. On the card the
ported kernels (B1 gather, B2 decode, B3 stem, B4 letterbox) launch under
their ``pallas_*`` knobs; on the CPU the same knobs take the kernels' plain
versions.

Numerics: ``precision: fp32`` means fp32 — on the card the engine turns
TF32 off for cuDNN convolutions and for matmuls (cuDNN defaults to TF32).
``half: true`` or ``precision: bf16`` means bf16, as in the JAX package.

Concurrency: the batcher runs up to ``pipeline_depth`` ``predict_packets``
calls at once in worker threads. A captured step's replays (input copied
in, graph launched, outputs copied out) take the engine's step lock; an
eager step allocates its own device tensors each call and shares only
read-only weights.
"""

from __future__ import annotations

import abc
import copy
import dataclasses
import logging
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ConfigError, DetectorConfig, TEMPORAL_MODEL_TYPES
from ..models.onnx_graph_model import graph_dtype, load_graph_fallback
from ..models.resnet import build_resnet, normalize_imagenet, variant_from_model_path
from ..models.weights import (
    calibrate_int8_activations,
    load_resnet_checkpoint,
    load_yolo_checkpoint,
    params_from_jax,
    params_to_tree,
    quantize_params_int8,
    resnet_params_from_jax,
    resnet_synthetic_params,
)
from ..models.s2d import s2d_conv_weight
from ..models.yolo import YoloModel, build_yolo, size_from_model_path
from ..ops.boxes import unletterbox_boxes
from ..ops.int8 import QuantConv, pack_int8_weight
from ..ops.letterbox import (
    LetterboxOperands,
    letterbox,
    letterbox_operands,
    stretch_resize,
    stretch_spec,
)
from ..ops.nms import batched_nms
from ..ops.preprocess import (
    integer_axis_reduction,
    letterbox_numpy,
    letterbox_spec,
    preprocess_batch,
)
from ..ops.tiling import crop_tile, merge_frame, tile_grid
from ..parallel.mesh import ShardedModel, make_mesh
from ..telemetry import spans
from ..types import BatchResult, Detection, FramePacket
from .graphs import CapturedStep, EagerStep, StepCache

logger = logging.getLogger(__name__)


class BaseDetector(abc.ABC):
    """Single-packet predict interface (reference detector.py:43-51), and
    what every engine family shares: the mesh helpers and the steps.

    An engine keeps one prepared step per key in ``_steps``, as the JAX
    engines keep one ``jax.jit`` program per key, under JAX's keys: ``(B,
    H, W, "sel")`` and ``(B, H, W)`` for YOLO, ``(B, "rsz")`` and ``(B, H,
    W)`` for the classifiers (host-resized input and full frames). A family
    supplies the host-prepare decision of a source (``_host_prepares``),
    the key of a batch (``_step_key``), the step function of a key and its
    input shape (``_step_fn``), and whether it captures its steps
    (``_captures``); the bucket choice, the warmup and the timed run of a
    step are this class's."""

    config: DetectorConfig
    mesh = None  # set by _init_mesh when detector.mesh_shape is configured
    sharded = None  # the model over the mesh (parallel/mesh.ShardedModel)
    _step_span = "step"  # the span an eager step's run on a host batch records

    @abc.abstractmethod
    def predict(self, packet: FramePacket) -> List[Detection]:
        raise NotImplementedError

    def close(self) -> None:  # pragma: no cover - optional override
        pass

    # -- multi-device helpers (every engine family shares these) -------------

    @property
    def net(self):
        """The model a device step calls: over the mesh when one is
        configured."""
        return self.model if self.sharded is None else self.sharded

    def _init_mesh(self, devices: Optional[Sequence] = None) -> None:
        """``detector.mesh_shape = [dp, tp]`` -> the mesh and the model over
        it (the JAX engines' ``_init_mesh``): over ``devices`` when given,
        dp x tp entries of the CPU for ``device: cpu``, else the cards
        ``cuda:0..n-1`` (raising when fewer are visible). Graph-backed
        models (foreign ONNX graphs) allow dp-only meshes (tp == 1): the
        batch shards over dp with replicated weights, since channel-sharding
        a foreign graph's weights is a layout its author never validated."""
        cfg = self.config
        self.mesh = self.sharded = None
        if not cfg.mesh_shape:
            return
        shape = tuple(int(v) for v in cfg.mesh_shape)
        graph = getattr(self, "_graph_backed", False) or getattr(self.model, "graph_backed",
                                                                False)
        if graph and len(shape) > 1 and shape[1] != 1:
            raise ConfigError(
                "generic ONNX graph models support dp-only meshes — "
                f"use mesh_shape: [{int(np.prod(shape))}, 1] (batch "
                "sharding), or shard streams across chips with "
                "`--shards`"
            )
        n = int(np.prod(shape))
        if devices is None and self.device.type == "cpu":
            devices = [self.device] * n
        self.use_mesh(make_mesh(n, shape=shape, devices=devices))

    def use_mesh(self, mesh) -> None:
        """Serve over ``mesh``: the model over it (``ShardedModel``), B3
        off, and the steps prepared off the mesh dropped. ``_init_mesh``
        comes here with the (dp, tp) mesh of ``mesh_shape``; a (dp, sp, tp)
        mesh, which no config key names (the JAX engine's ``mesh_shape`` is
        [dp, tp] too), is given here by the caller."""
        if mesh.lead(0) != self.device:
            raise ConfigError(f"the mesh's first device {mesh.lead(0)} is not the "
                              f"engine's device {self.device}")
        if isinstance(self.model, YoloModel):
            self.model.pallas_stem = "off"
        self.mesh, self.sharded = mesh, ShardedModel(self.model, mesh)
        self._steps = StepCache()

    def _round_mesh(self, bucket: int) -> int:
        """In mesh mode the batch shards over dp, so buckets round up to a
        dp multiple."""
        if self.mesh is not None:
            dp = self.mesh.shape["dp"]
            bucket = ((bucket + dp - 1) // dp) * dp
        return bucket

    # -- the steps (every engine family shares these) ----------------------

    def _init_steps(self) -> None:
        self._steps = StepCache()
        self._bucket_cost_ms: Dict[Tuple[int, int], Dict[int, float]] = {}
        self.last_infer_ms = 0.0

    def _host_resize_active(self) -> bool:
        """auto = on for the card (as the JAX package does for its TPU:
        upload the resized content, run the lean step), off for the CPU."""
        return self.config.host_resize == "on" or (
            self.config.host_resize == "auto" and self.device.type == "cuda"
        )

    def _host_prepares(self, src_hw: Tuple[int, int]) -> bool:
        """Whether the host picks or resizes frames of ``src_hw`` before
        the upload, as serving decides it."""
        return self.host_prepare(np.zeros((1, *src_hw, 3), np.uint8), src_hw)[1]

    def _step_key(self, batch: int, src_hw: Tuple[int, int], prepared: bool):
        """The classifiers' keys, JAX's: one host-resized step of a batch
        serves every source."""
        return (batch, "rsz") if prepared else (batch, *src_hw)

    def _step_fn(self, key) -> Tuple[Callable, Tuple[int, ...]]:
        """(the eager step of ``key`` on a uint8 device batch, the batch's
        shape)."""
        raise NotImplementedError

    def _captures(self) -> bool:
        """Whether this engine captures its steps as CUDA graphs."""
        return False

    def _buckets(self, src_hw: Tuple[int, int]) -> Sequence[int]:
        """The buckets a batch of ``src_hw`` may run at."""
        return self.config.resolved_buckets

    def _make_step(self, key):
        """The step of ``key``: the eager step, captured where the engine
        captures (a failed capture raises, naming the key)."""
        fn, shape = self._step_fn(key)
        if not self._captures():
            return EagerStep(fn, self.device, self._step_span)
        logger.info("capturing step %s", key)
        step = CapturedStep(fn, shape, torch.uint8, self.device, key=key, cache=self._steps)
        logger.info("captured step %s in %.2fs: launches a replay %s", key, step.capture_s,
                    step.launches)
        return step

    def step_for(self, batch: int, src_hw: Tuple[int, int], prepared: Optional[bool] = None):
        """(step, fn): the cached step that serves ``batch`` frames (clips)
        of ``src_hw``, made at its first use, and the eager function it was
        made from. The step takes the input serving uploads: host-picked or
        host-resized where the host prepares it (``prepared``; None: as
        serving decides for ``src_hw``)."""
        if prepared is None:
            prepared = self._host_prepares(src_hw)
        key = self._step_key(batch, tuple(src_hw), prepared)
        return self._steps.setdefault_made(key, lambda: self._make_step(key)), \
            self._step_fn(key)[0]

    def eager_twin(self):
        """A shallow copy of this engine over its model, weights and
        prepared state that serves from eager steps and bucket costs of its
        own: what a captured step is held to."""
        twin = copy.copy(self)
        twin._init_steps()
        twin._captures = lambda: False
        return twin

    def _run_step(self, key, batch) -> Tuple[np.ndarray, ...]:
        """The cached step of ``key`` on a host batch (an array, or a
        tensor in host memory, uploaded as it is): its outputs as arrays,
        and its time in ``last_infer_ms``."""
        step = self._steps.setdefault_made(key, lambda: self._make_step(key))
        t0 = time.perf_counter()
        out = step.run_host(batch)
        self.last_infer_ms = (time.perf_counter() - t0) * 1e3
        return out

    def _run_bucket(self, bucket: int, frames: np.ndarray, src_hw: Tuple[int, int],
                    prepared: bool):
        """``frames`` padded to ``bucket`` (more than it run unpadded)
        through the step of their key: the outputs of the frames."""
        n = frames.shape[0]
        out = self._run_step(self._step_key(max(n, bucket), src_hw, prepared),
                             _padded(frames, bucket))
        return tuple(o[:n] for o in out)

    def _effective_bucket(self, n: int, src_hw: Tuple[int, int]) -> int:
        """The cheapest warmed bucket that fits n frames, for THIS source
        resolution (costs are per resolution), else the smallest; rounded
        up to a multiple of dp under a mesh."""
        return self._round_mesh(_cheapest_bucket(
            self._buckets(src_hw), n, self._bucket_cost_ms.get(tuple(src_hw), {})))

    def warmup(self, src_hw: Tuple[int, int], buckets: Optional[Sequence[int]] = None):
        """Prepare every bucket's step (on the card: warm it, which settles
        allocations, cuDNN's algorithm choice and the first-use kernel
        build, and capture it where the engine captures), then time it (min
        of 3) for cost-aware bucket choice, on zeros of the input serving
        uploads, so that the choice compares the steps that serve. Under a
        mesh each bucket runs rounded to dp, as serving runs it; its cost
        is recorded under the bucket before rounding, the key the choice
        compares."""
        src_hw = (int(src_hw[0]), int(src_hw[1]))
        avail = self._buckets(src_hw)
        prepared = self._host_prepares(src_hw)
        costs = self._bucket_cost_ms.setdefault(src_hw, {})
        for b in buckets or avail:
            b = _bucket_for(avail, b)
            rb = self._round_mesh(b)
            key = self._step_key(rb, src_hw, prepared)
            zeros = np.zeros(self._step_fn(key)[1], np.uint8)
            self._run_bucket(rb, zeros, src_hw, prepared)
            cost = float("inf")
            for _ in range(3):
                self._run_bucket(rb, zeros, src_hw, prepared)
                cost = min(cost, self.last_infer_ms)
            costs[b] = cost
            logger.info("warmup: bucket B=%d src=%s step %s: %.1fms", rb, src_hw, key, cost)


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


def _calibration_frames(input_hw: Tuple[int, int], n: int = 4) -> List[np.ndarray]:
    """Model-ready int8 calibration inputs, as the JAX package's: letterboxed
    frames of the synthetic video source (moving boxes over a structured
    background) at 1080p (seed 0) and 854x480 (seed 1), each [1, H, W, 3]
    fp32 RGB in [0, 1] (``letterbox_numpy``)."""
    from ..ingest.synthetic import SyntheticSource

    out: List[np.ndarray] = []
    for seed, (h, w) in enumerate(((1080, 1920), (480, 854))):
        src = SyntheticSource(width=w, height=h, boxes=5, seed=seed)
        for _ in range(max(1, n // 2)):
            ok, frame = src.read()
            if not ok:
                break
            tensor, _meta = letterbox_numpy(frame, input_hw)  # [1, 3, H, W] RGB
            out.append(tensor.transpose(0, 2, 3, 1).astype(np.float32))
    return out


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


def _padded(frames: np.ndarray, bucket: int) -> np.ndarray:
    """``frames`` padded with zero frames up to ``bucket``."""
    n = frames.shape[0]
    if n >= bucket:
        return frames
    return np.concatenate([frames, np.zeros((bucket - n, *frames.shape[1:]), frames.dtype)])


def by_frame_shape(frames: Iterable[np.ndarray]) -> Dict[Tuple[int, int], List[int]]:
    """The indices of ``frames`` by frame shape (H, W), in first-seen order."""
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, f in enumerate(frames):
        groups.setdefault(tuple(f.shape[:2]), []).append(i)
    return groups


class PreparedState:
    """What an engine prepares once for its device steps besides the
    model's weights: the family's own tensors (``_own_state``) and B4's
    operands of each source geometry (``operands_for``), which the live
    steps read too. ``engine/export.py`` stores ``prepared_state`` in an
    artifact and traces the steps of a copy ``bind``-ed to a program's
    inputs, so that no prepared tensor is baked into a program."""

    device: torch.device
    _operands: Dict[Tuple[int, int], LetterboxOperands]
    _bound = False

    def _operands_spec(self, src_hw: Tuple[int, int]):
        """(the B4 spec, the output dtype) of frames of ``src_hw``."""
        raise NotImplementedError

    def _own_state(self) -> Dict:
        return {}

    def _bind_own(self, state: Dict) -> None:
        pass

    def operands_for(self, src_hw: Tuple[int, int]) -> LetterboxOperands:
        """B4's operands of frames of ``src_hw``: built at the first call
        and kept; a bound copy has only those of its state."""
        src_hw = (int(src_hw[0]), int(src_hw[1]))
        ops = self._operands.get(src_hw)
        if ops is None:
            if self._bound:
                raise ValueError(f"B4's operands of {src_hw} are not in the bound state")
            spec, dtype = self._operands_spec(src_hw)
            ops = self._operands[src_hw] = letterbox_operands(spec, dtype, self.device)
        return ops

    def prepared_state(self, src_hws: Sequence[Tuple[int, int]] = ()) -> Dict:
        """The tensors the steps read besides the model's weights, as a
        tree: the family's own and, under ``letterbox/<H>x<W>``, B4's tables
        of each of ``src_hws``."""
        tree = self._own_state()
        for h, w in src_hws:
            ops = self.operands_for((h, w))
            tree.setdefault("letterbox", {})[f"{h}x{w}"] = {
                "taps": ops.taps, "weights": ops.weights, "spans": ops.spans}
        return tree

    def bind(self, model, state: Dict):
        """A shallow copy of this engine whose steps read ``model`` and
        ``state`` (a tree shaped as ``prepared_state``'s) in place of its
        own. This engine is left as it is, so it may serve meanwhile."""
        missing = set(self._own_state()) - set(state)
        if missing:
            raise ValueError(f"bind: the state lacks {sorted(missing)}")
        bound = copy.copy(self)
        bound.model, bound._bound = model, True
        bound._operands = {}
        for key, t in state.get("letterbox", {}).items():
            hw = tuple(int(v) for v in key.split("x"))
            bound._operands[hw] = LetterboxOperands(
                t["taps"], t["weights"], t["spans"], self.operands_for(hw).ints)
        bound._bind_own(state)
        bound._steps = StepCache()  # its steps read the bound tensors
        return bound


class TorchYoloEngine(PreparedState, BaseDetector):
    """YOLOv5/v8 engine with batched inference on one card (or the CPU)."""

    def __init__(self, config: DetectorConfig, params: Optional[Dict] = None,
                 devices: Optional[Sequence] = None):
        """``devices``: the mesh's devices under ``mesh_shape`` (see
        ``_init_mesh``)."""
        config.validate()
        self.config = config
        self.device = pick_device(config)
        fp32_means_fp32(self.device)
        model_type = config.model_type if config.model_type in ("yolov5", "yolov8") \
            else "yolov8"
        self.model = build_yolo(model_type, size_from_model_path(config.model_path),
                                config.num_classes)
        self.input_hw: Tuple[int, int] = config.resolved_input_size
        self.compute_dtype = compute_dtype_of(config)
        if params is None:
            params = load_yolo_checkpoint(self.model, config.model_path)
        graph = None
        if params is None:
            graph = load_graph_fallback(
                config.model_path, "yolo", model_type=model_type,
                input_hw=tuple(self.input_hw),
                compute_dtype=graph_dtype(config.graph_precision))
        self._graph_backed = graph is not None
        if graph is not None:
            self._init_graph(graph)
        else:
            if params is None:
                logger.warning(
                    "No loadable weights at '%s' — using a seeded random init "
                    "(seed 0). Detections will be meaningless until a checkpoint "
                    "is provided.", config.model_path,
                )
                self.model.init_params(torch.Generator().manual_seed(0))
            if config.precision == "int8":
                self._init_int8(params)
            else:
                if params is not None:
                    params_from_jax(self.model, params)
                self.model.to(device=self.device, dtype=self.compute_dtype,
                              memory_format=torch.channels_last).eval()
                self.model.fuse_neck = fuse_neck_on(self.device)
                if self.model.fuse_neck:
                    self.model.prepare_neck()
        self._nms_gather = "torch" if config.pallas_gather == "off" else "kernel"
        self._w0_folded = self._stem_folded = self._stem_plain = None
        self._s2d_w0_folded = None
        if not self._graph_backed:
            self.model.pallas_decode = "off" if config.pallas_decode == "off" else "on"
            self.model.pallas_stem = "off" if config.pallas_stem == "off" else "on"
            if config.mesh_shape:
                # auto resolves to off under a mesh; an explicit request warns
                if config.pallas_stem in ("on", "interpret"):
                    logger.warning(
                        "pallas_stem: %s ignored under mesh serving — the fused stem "
                        "kernel has no sharded form (its stem weights are tp-sharded; "
                        "B1, B4 and B6 run per dp shard); serving stays on the "
                        "layer-by-layer stem", config.pallas_stem)
                self.model.pallas_stem = "off"
            self._w0_folded = self._fold_stem()
            if self.model.stem_nodes_ok():
                self._stem_folded = self.model.stem_weights(self.compute_dtype,
                                                            self._w0_folded)
                self._stem_plain = self.model.stem_weights(self.compute_dtype)
            if self._s2d_for_bucket(None) and not self.model.act_int8:
                # the s2d prefix's weights, scattered once (models/s2d.py)
                self.model.prepare_s2d()
                if self.model.s2d_prep is not None:
                    self._s2d_w0_folded = s2d_conv_weight(self._w0_folded, 4, 2, 2,
                                                          self.model.nodes[0].p)
        self._class_mask = None
        if config.classes:
            mask = torch.zeros(config.num_classes, dtype=torch.bool)
            mask[torch.as_tensor(config.classes, dtype=torch.long)] = True
            self._class_mask = mask.to(self.device)
        self._init_steps()
        self.class_agnostic_nms = True  # reference NMS is class-agnostic
        self._operands = {}
        # multi-device: detector.mesh_shape = [dp, tp] shards the convs'
        # channels over tp and every batch over dp (graph-backed: dp only)
        self._init_mesh(devices)

    def _init_graph(self, graph) -> None:
        """A foreign ONNX graph as the model (the JAX engine's graph
        branch): the compute dtype is the graph's (``graph_precision``; fp32
        by default, the device letterbox feeding it included); no int8 (a
        warning), no stem fold; params cast to bf16 under the bf16 policy,
        quantization scales exempt."""
        self.model = graph
        self.compute_dtype = graph.compute_dtype
        if self.config.precision == "int8":
            logger.warning(
                "precision: int8 is not supported for generic ONNX graph models — "
                "serving the graph at graph_precision (%s)", self.config.graph_precision)
        to_graph_device(graph, self.device)

    def _init_int8(self, params: Optional[Dict]) -> None:
        """Native int8, as the JAX engine's int8 branch: quantise the float
        tree, load it (its convs then run int8: ``act_int8``) and bake
        static activation scales from ``_calibration_frames`` in one fp32
        pass on the engine's device. No float parameter is cast to the compute dtype (biases,
        scales and v5 anchors stay fp32); serving still feeds bf16 pixels.
        The JAX engine serves with dynamic scales when calibration fails;
        here a failure raises."""
        tree = params if params is not None else params_to_tree(self.model)
        params_from_jax(self.model, quantize_params_int8(tree))
        self.model.to(device=self.device, memory_format=torch.channels_last).eval()
        baked = calibrate_int8_activations(
            self.model, _calibration_frames(self.input_hw), self.device)
        logger.info("int8 mode: %d static calibrated activation scales", baked)

    def _fold_stem(self):
        """BGR->RGB and /255 are linear in the input, so the selected step
        folds them into the stem conv (input-channel flip + scale), once, in
        the JAX order. A float stem: the weight in the compute dtype,
        flipped, times 1/255. An int8 stem: ``w_q``'s input channels
        flipped, ``w_scale / 255``, and ``a_scale * 255`` (the scale was
        calibrated on [0, 1] inputs and this step feeds raw pixels)."""
        l0 = self.model.layers["0"]
        if l0.w_q is None:
            w0 = l0.weight
            return torch.flip(w0, dims=[1]) * torch.tensor(
                1.0 / 255.0, dtype=w0.dtype, device=w0.device)
        return QuantConv(pack_int8_weight(torch.flip(l0.w_q, dims=[1])),
                         l0.w_scale * (1.0 / 255.0),
                         None if l0.a_scale is None else l0.a_scale * 255.0)

    # -- prepared state (engine/export.py) ---------------------------------

    def _operands_spec(self, src_hw):
        return letterbox_spec(src_hw, self.input_hw), self.compute_dtype

    def _own_state(self) -> Dict:
        """The folded stem conv (float, or int8 with its scales), B3's
        operands of both stems, the class mask."""
        tree: Dict = {}
        w0 = self._w0_folded
        if isinstance(w0, QuantConv):
            tree["w0_folded"] = {k: v for k, v in w0._asdict().items() if v is not None}
        elif w0 is not None:
            tree["w0_folded"] = {"w": w0}
        for name in ("stem_folded", "stem_plain"):
            sw = getattr(self, "_" + name)
            if sw is not None:
                tree[name] = {f.name: getattr(sw, f.name) for f in dataclasses.fields(sw)
                              if isinstance(getattr(sw, f.name), torch.Tensor)}
        if self._s2d_w0_folded is not None:
            tree["s2d_w0_folded"] = {"w": self._s2d_w0_folded[0]}
        if self._class_mask is not None:
            tree["class_mask"] = self._class_mask
        return tree

    def _bind_own(self, state: Dict) -> None:
        if isinstance(self._w0_folded, QuantConv):
            self._w0_folded = self._w0_folded._replace(**state["w0_folded"])
        elif self._w0_folded is not None:
            self._w0_folded = state["w0_folded"]["w"]
        for name in ("stem_folded", "stem_plain"):
            sw = getattr(self, "_" + name)
            if sw is not None:
                setattr(self, "_" + name, dataclasses.replace(sw, **state[name]))
        if self._s2d_w0_folded is not None:
            self._s2d_w0_folded = (state["s2d_w0_folded"]["w"], *self._s2d_w0_folded[1:])
        if self._class_mask is not None:
            self._class_mask = state["class_mask"]

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
        if self._graph_backed:
            # the selected step folds BGR and /255 into the YOLO stem conv;
            # a foreign graph has no known stem: the device letterbox
            return frames, False
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

    @staticmethod
    def _host_resize_packets(frames, spec) -> Optional[np.ndarray]:
        """cv2 INTER_LINEAR resize of each frame to the letterbox content
        size, straight into one batch buffer. None when cv2 is unavailable
        or the geometry is a no-op."""
        if (spec.new_h, spec.new_w) == (spec.src_h, spec.src_w):
            return None
        try:
            return cv2_stretch(frames, (spec.new_h, spec.new_w))
        except ImportError:
            return None

    # -- device steps -----------------------------------------------------

    def _final_select(self, out):
        """Model output -> padded per-image (boxes, scores, classes,
        num_valid) through the class mask, the confidence threshold and
        batched NMS. An end-to-end graph export already selected its boxes
        with its own per-class NMS (the engine's class-agnostic NMS would
        cross-suppress boxes it keeps), so it takes a confidence top-k."""
        cfg = self.config
        boxes = out["boxes_xyxy"].to(torch.float32)
        conf = out["conf"]
        cls = out["cls"]
        if self._class_mask is not None:
            conf = torch.where(self._class_mask[cls.long()], conf, 0.0)
        conf = torch.where(conf >= cfg.confidence_threshold, conf, 0.0)
        if getattr(self.model, "end2end", False):
            k = min(cfg.max_detections, conf.shape[1])
            s, idx = torch.sort(conf, dim=1, descending=True, stable=True)  # ties: lower
            s, idx = s[:, :k], idx[:, :k]  # index first, as lax.top_k
            b = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
            c = torch.gather(cls, 1, idx)
            n = (s > 0).sum(dim=1).to(torch.int32)
            pad = cfg.max_detections - k  # keep the engine's fixed width
            return F.pad(b, (0, 0, 0, pad)), F.pad(s, (0, pad)), F.pad(c, (0, pad)), n
        return batched_nms(
            boxes, conf, cls,
            iou_threshold=cfg.iou_threshold,
            max_det=cfg.max_detections,
            pre_topk=min(cfg.pre_nms_topk, boxes.shape[1]),
            class_agnostic=self.class_agnostic_nms,
            gather_impl=self._nms_gather,
            mesh=self.mesh,
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

    def _s2d_for_bucket(self, batch: Optional[int]) -> bool:
        """The JAX engine's policy for the s2d early backbone (``batch``:
        the step's bucket; None: any): ``on`` means on; ``auto`` is decided
        per bucket on a single-chip TPU only, so it is off on ``cuda`` and
        ``cpu``; ``off`` means off. The prefix itself skips int8 weights
        and inputs whose sides are not multiples of 4."""
        return self.config.s2d_backbone == "on"

    def _s2d_kwargs(self, batch: int, folded: bool) -> Dict:
        """The forward's s2d arguments for a step of ``batch`` (a foreign
        graph has no YOLO prefix)."""
        if self._graph_backed or not self._s2d_for_bucket(batch):
            return {}
        return dict(s2d=True, s2d_w0=self._s2d_w0_folded if folded else None)

    def _forward_selected(self, x: torch.Tensor):
        """The model on a ``_pad_cast`` input: the stem-folded weights take
        raw BGR pixels."""
        return self.net(x, reduce_scores=True, w0=self._w0_folded,
                        stem_weights=self._stem_folded,
                        **self._s2d_kwargs(x.shape[0], folded=True))

    def _step_selected(self, sel_u8: torch.Tensor, spec):
        """Over host-picked input: pad + cast, forward with the stem-folded
        weights, NMS, un-letterbox to the ORIGINAL source geometry."""
        out = self._forward_selected(self._pad_cast(sel_u8, spec))
        return self._finish(out, spec)

    def _device_letterbox(self, frames_u8: torch.Tensor, spec) -> torch.Tensor:
        """Full frames -> the letterboxed RGB [0, 1] model input, NHWC, as
        JAX ``_build_step``: kernel B4 when ``pallas_preprocess`` is on, or
        auto on the card and the letterbox resizes (an identity geometry
        skips it); else the plain ``preprocess_batch``, which is what auto
        takes on the CPU, as the JAX package's auto does off the TPU. B4's
        wrapper takes its plain version for a CPU tensor under ``on``."""
        mode = self.config.pallas_preprocess
        needs_resize = (spec.new_h, spec.new_w) != (spec.src_h, spec.src_w)
        if mode == "on" or (mode == "auto" and needs_resize and frames_u8.is_cuda):
            return letterbox(frames_u8, spec, self.compute_dtype,
                             self.operands_for((spec.src_h, spec.src_w)), self.mesh)
        return preprocess_batch(frames_u8, spec=spec, out_dtype=self.compute_dtype,
                                layout="NHWC")

    def _step_device_resize(self, frames_u8: torch.Tensor, spec):
        """Over full frames [B, H, W, 3] uint8 BGR: device letterbox (B4 or
        plain), forward with the plain stem weights, NMS, un-letterbox."""
        x = self._device_letterbox(frames_u8, spec)
        out = self.net(x, reduce_scores=True, stem_weights=self._stem_plain,
                       **self._s2d_kwargs(x.shape[0], folded=False))
        return self._finish(out, spec)

    def _finish(self, out, spec):
        b, s, c, n = self._final_select(out)
        b = unletterbox_boxes(b, spec.scale, spec.pad_left, spec.pad_top,
                              spec.src_h, spec.src_w)
        return b, s, c, n

    # -- the steps ----------------------------------------------------------

    def _captures(self) -> bool:
        """On the card, off a mesh (multi-device capture is not done yet)
        and for a native YOLO model (a graph-backed model's interpreter is
        not yet held capture-safe)."""
        return self.device.type == "cuda" and self.mesh is None and not self._graph_backed

    def _step_key(self, batch: int, src_hw: Tuple[int, int], selected: bool):
        return (batch, *src_hw, "sel") if selected else (batch, *src_hw)

    def _step_fn(self, key):
        """The selected step over host-picked (or host-resized) input, or
        the device-resize step over full frames, each a closure over the
        static letterbox geometry of the key's source."""
        spec = letterbox_spec(key[1:3], self.input_hw)
        if key[3:] == ("sel",):
            return (lambda x: self._step_selected(x, spec)), (key[0], spec.new_h, spec.new_w, 3)
        return (lambda x: self._step_device_resize(x, spec)), (key[0], spec.src_h, spec.src_w, 3)

    def warmup(self, src_hw: Tuple[int, int], buckets: Optional[Sequence[int]] = None):
        super().warmup(src_hw, buckets)
        if self._tiling_active(src_hw) and tuple(src_hw) != tuple(self.input_hw):
            # tiled serving runs the input-sized step on the tile crops
            super().warmup(self.input_hw, buckets)

    # -- prediction -------------------------------------------------------

    def predict_arrays(self, frames: np.ndarray) -> BatchResult:
        """frames: [N, H, W, 3] uint8 BGR (all same resolution)."""
        with spans.engine_batch():
            src_hw = tuple(frames.shape[1:3])
            with spans.span("pick"):
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
        """Pad to exactly ``bucket`` and run its cached step: the batch
        copied in, the padded results copied out."""
        return BatchResult(*super()._run_bucket(bucket, frames, src_hw, selected))

    def _predict_group(self, frames_list: Sequence[np.ndarray],
                       shape: Tuple[int, int]) -> BatchResult:
        """Batch-predict same-resolution frames through the cheapest path
        (host pixel pick > host letterbox resize > device letterbox)."""
        with spans.span("pick"):
            frames, selected = self._group_batch(frames_list, shape)
        return self._predict_prepared(frames, shape, selected)

    def _group_batch(self, frames_list: Sequence[np.ndarray],
                     shape: Tuple[int, int]) -> Tuple[np.ndarray, bool]:
        """The group as one batch to upload, and whether the host picked or
        resized it (the selected step's input)."""
        if self._graph_backed:  # no stem to fold BGR and /255 into
            return np.stack(frames_list), False
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
            return frames, True
        if self._host_resize_active():
            frames = self._host_resize_packets(list(frames_list), spec)
            if frames is not None:
                return frames, True
        return np.stack(frames_list), False

    def _tiling_active(self, shape: Tuple[int, int]) -> bool:
        return bool(self.config.tiling) and (
            shape[0] > self.input_hw[0] or shape[1] > self.input_hw[1])

    def _predict_tiled_group(self, frames_list: Sequence[np.ndarray],
                             shape: Tuple[int, int]) -> BatchResult:
        """SAHI-style sliced inference (``ops/tiling.py``), as the JAX
        engine's: input-sized tile crops (a memcpy, detection at native
        resolution) ride the selected step (the identity pixel pick) in
        chunks of at most the largest bucket; the optional whole-frame pass
        merges back in, so that objects larger than a tile are seen whole."""
        th, tw = self.input_hw
        grid = tile_grid(shape, self.input_hw, self.config.tiling_overlap)
        n_tiles, nf = len(grid), len(frames_list)
        spec = letterbox_spec((th, tw), self.input_hw)
        geom = (self._select_geometry(spec)
                if self.config.host_select != "off" and not self._graph_backed else None)
        selected = geom == (1, 0, 1, 0)
        # one cap-sized buffer bounds the host's transient to one chunk
        cap = max(self.config.resolved_buckets)
        tiles = np.empty((min(cap, nf * n_tiles), th, tw, 3), np.uint8)
        parts, filled = [], 0
        for f in frames_list:
            for y0, x0 in grid:
                crop_tile(f, y0, x0, (th, tw), out=tiles[filled])
                filled += 1
                if filled == tiles.shape[0]:
                    parts.append(self._predict_prepared(tiles[:filled], (th, tw), selected))
                    filled = 0
        if filled:
            parts.append(self._predict_prepared(tiles[:filled], (th, tw), selected))
        tb, ts, tc, tn = (np.concatenate([getattr(p, f) for p in parts]) for f in
                          ("boxes_xyxy", "scores", "class_ids", "num_valid"))
        full = (self._predict_group(frames_list, shape)
                if self.config.tiling_full_frame else None)
        md = self.config.max_detections
        ob = np.zeros((nf, md, 4), np.float32)
        osc = np.zeros((nf, md), np.float32)
        oc = np.zeros((nf, md), np.int32)
        on = np.zeros((nf,), np.int32)
        for j in range(nf):
            per_tile = [(tb[j * n_tiles + t], ts[j * n_tiles + t], tc[j * n_tiles + t],
                         int(tn[j * n_tiles + t])) for t in range(n_tiles)]
            if full is not None:  # past len(grid): already in frame coordinates
                per_tile.append((full.boxes_xyxy[j], full.scores[j], full.class_ids[j],
                                 int(full.num_valid[j])))
            ob[j], osc[j], oc[j], on[j] = merge_frame(
                per_tile, grid, shape, self.config.iou_threshold, md,
                self.class_agnostic_nms)
        return BatchResult(boxes_xyxy=ob, scores=osc, class_ids=oc, num_valid=on)

    def predict_packets(self, packets: Sequence[FramePacket]) -> List[List[Detection]]:
        """Batch-predict frame packets; groups by source resolution, and
        tiles a group larger than the input when ``tiling`` is on."""
        with spans.engine_batch():
            return self._predict_packets(packets)

    def _predict_packets(self, packets: Sequence[FramePacket]) -> List[List[Detection]]:
        results: List[List[Detection]] = [[] for _ in packets]
        for shape, idxs in by_frame_shape(p.frame for p in packets).items():
            frames_list = [packets[i].frame for i in idxs]
            if self._tiling_active(shape):
                br = self._predict_tiled_group(frames_list, shape)
            else:
                br = self._predict_group(frames_list, shape)
            with spans.span("detections"):
                dets = br.to_detections(
                    [packets[i].stream.name for i in idxs],
                    [packets[i].frame_id for i in idxs],
                )
                for j, i in enumerate(idxs):
                    results[i] = dets[j]
        return results

    def predict(self, packet: FramePacket) -> List[Detection]:
        return self.predict_packets([packet])[0]


def compute_dtype_of(config: DetectorConfig) -> torch.dtype:
    """fp32 when ``precision: fp32`` and not ``half``, else bf16 (the JAX
    package's rule; ``half`` means the card's half type, bf16)."""
    if config.precision == "fp32" and not config.half:
        return torch.float32
    return torch.bfloat16


def to_graph_device(graph, device: torch.device) -> None:
    """A graph model's params onto ``device``, cast to its compute dtype
    under the bf16 policy (quantization scales exempt)."""
    graph.to(device)
    if graph.compute_dtype != torch.float32:
        graph.cast_params(graph.compute_dtype)
    graph.eval()


def fuse_neck_on(device: torch.device) -> bool:
    """Whether an engine on ``device`` fuses its YOLO model's neck: on the
    card, as the JAX package's forward does (the upsampled tensor and the
    concat never reach device memory). The CPU runs the neck layer by
    layer: the same function up to fp32 rounding, on which the port's CPU
    tests of detection order were made (they hold scores tied to the last
    bit, which a change of rounding may reorder)."""
    return device.type == "cuda"


def fp32_means_fp32(device: torch.device) -> None:
    """On the card, turn TF32 off: cuDNN convolutions default to it."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def bgr_unit_rgb(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 BGR NHWC -> fp32 RGB in [0, 1] (the resized steps' cast)."""
    return frames_u8.to(torch.float32).flip(-1) * (1.0 / 255.0)


def stretch_unit_rgb(frames_u8: torch.Tensor, dst_hw: Tuple[int, int],
                     kernel: bool,
                     operands: Optional[LetterboxOperands] = None,
                     mesh=None) -> torch.Tensor:
    """Full frames [B, H, W, 3] uint8 BGR -> fp32 RGB in [0, 1] at
    ``dst_hw``, as the JAX ResNet and temporal device steps: kernel B4's
    stretch (rounded to uint8 levels) when ``kernel``, once per dp shard
    under ``mesh``, else bilinear ``F.interpolate`` with no rounding, then
    the flip and /255. ``operands``: B4's tables, in a traced step."""
    if kernel:
        return stretch_resize(frames_u8, dst_hw, torch.float32, operands, mesh)
    x = frames_u8.to(torch.float32).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=tuple(dst_hw), mode="bilinear", align_corners=False)
    return x.permute(0, 2, 3, 1).flip(-1) * (1.0 / 255.0)


def cv2_stretch(frames: Sequence[np.ndarray], dst_hw: Tuple[int, int],
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """cv2 INTER_LINEAR stretch of each frame to ``dst_hw``, straight into
    one uint8 batch buffer (the reference classifiers' host preprocess)."""
    import cv2

    th, tw = dst_hw
    if out is None:
        out = np.empty((len(frames), th, tw, 3), dtype=np.uint8)
    for i, frame in enumerate(frames):
        cv2.resize(frame, (tw, th), dst=out[i], interpolation=cv2.INTER_LINEAR)
    return out


class TorchResNetEngine(PreparedState, BaseDetector):
    """ResNet classification engine (counterpart of ``JaxResNetEngine``).

    Stretches without letterbox, ImageNet-normalizes and emits the top-K
    classes as full-frame Detections. With ``host_resize`` active (auto =
    on for the card) the stretch runs on the host with cv2 INTER_LINEAR,
    as the reference classifier resizes, and only input-sized pixels cross
    the link; the device step is then cast, flip, /255, normalize and the
    forward. Otherwise the device step stretches the full frames: kernel
    B4 on the card unless ``pallas_preprocess: off``, else the JAX
    package's unrounded bilinear resize."""

    def __init__(self, config: DetectorConfig, params: Optional[Dict] = None,
                 devices: Optional[Sequence] = None):
        config.validate()
        self.config = config
        self.device = pick_device(config)
        fp32_means_fp32(self.device)
        self.model = build_resnet(variant_from_model_path(config.model_path),
                                  config.resnet_num_classes)
        self.input_hw: Tuple[int, int] = config.resolved_input_size
        self.compute_dtype = compute_dtype_of(config)
        if params is None:
            params = load_resnet_checkpoint(self.model, config.model_path)
        graph = None
        if params is None:  # a classifier graph (reference detector.py:1004-1134)
            graph = load_graph_fallback(
                config.model_path, "classifier", input_hw=tuple(self.input_hw),
                compute_dtype=graph_dtype(config.graph_precision))
        if graph is not None:
            self.model, self.compute_dtype = graph, graph.compute_dtype
            to_graph_device(graph, self.device)
        else:
            if params is None:
                logger.warning(
                    "No loadable ResNet weights at '%s' — using seeded random "
                    "weights (seed 0).", config.model_path,
                )
                params = resnet_synthetic_params(self.model, seed=0)
            resnet_params_from_jax(self.model, params)
            self.model.to(device=self.device, dtype=self.compute_dtype,
                          memory_format=torch.channels_last).eval()
        self._init_steps()
        self._operands = {}
        # multi-device: [dp, tp] shards conv channels over tp, batches over
        # dp (classifier graphs: dp only)
        self._init_mesh(devices)

    def _operands_spec(self, src_hw):
        return stretch_spec(src_hw, self.input_hw), torch.float32

    def host_prepare(self, frames, src_hw: Tuple[int, int]):
        """(prepared uint8 frames, resized: bool). With ``host_resize``
        active the stretch to ``input_size`` runs here (cv2 INTER_LINEAR);
        without cv2 the full frames go to the device step."""
        if tuple(src_hw) != tuple(self.input_hw) and self._host_resize_active():
            try:
                return cv2_stretch(frames, self.input_hw), True
            except ImportError:
                return frames, False
        return frames, False

    def _classify_head(self, x: torch.Tensor):
        """x: [B, th, tw, 3] fp32 RGB in [0, 1] -> (top-k scores, classes);
        raw head outputs unless ``resnet_scores: softmax``."""
        x = normalize_imagenet(x).to(self.compute_dtype)
        logits = self.net(x).to(torch.float32)
        k = min(self.config.resnet_top_k, logits.shape[-1])
        scores = torch.softmax(logits, dim=-1) if self.config.resnet_scores == "softmax" else logits
        return torch.topk(scores, k, dim=-1)

    def _step(self, frames_u8: torch.Tensor, resized: bool):
        if resized:
            x = bgr_unit_rgb(frames_u8)
        else:
            kernel = self.config.pallas_preprocess != "off" and self.device.type == "cuda"
            x = stretch_unit_rgb(frames_u8, self.input_hw, kernel,
                                 self.operands_for(frames_u8.shape[1:3]) if kernel else None,
                                 self.mesh)
        return self._classify_head(x)

    def _step_fn(self, key):
        resized = key[1] == "rsz"
        hw = self.input_hw if resized else key[1:3]
        return (lambda x: self._step(x, resized)), (key[0], *hw, 3)

    def classify(self, frames) -> Tuple[np.ndarray, np.ndarray]:
        """frames: same-resolution uint8 BGR frames (an array or a list) ->
        (scores [N, k], classes [N, k]), best first."""
        src_hw = tuple(frames[0].shape[:2])
        prepared, resized = self.host_prepare(frames, src_hw)
        if not resized:
            prepared = np.stack(prepared) if isinstance(prepared, list) else prepared
        # more frames than the largest bucket run unpadded, as in JAX
        return self._run_bucket(self._effective_bucket(len(prepared), src_hw), prepared,
                                src_hw, resized)

    def predict_packets(self, packets: Sequence[FramePacket]) -> List[List[Detection]]:
        results: List[List[Detection]] = [[] for _ in packets]
        for (h, w), idxs in by_frame_shape(p.frame for p in packets).items():
            scores, classes = self.classify([packets[i].frame for i in idxs])
            for j, i in enumerate(idxs):
                p = packets[i]
                results[i] = [
                    Detection(stream_name=p.stream.name, frame_id=p.frame_id,
                              class_id=int(classes[j, r]), confidence=float(scores[j, r]),
                              bbox_xyxy=(0.0, 0.0, float(w), float(h)))
                    for r in range(scores.shape[1])
                    if scores[j, r] >= self.config.confidence_threshold
                ]
        return results

    def predict(self, packet: FramePacket) -> List[Detection]:
        return self.predict_packets([packet])[0]


def create_detector(config: DetectorConfig) -> BaseDetector:
    """Factory with the reference's routing semantics (detector.py:54-96):
    temporal model types -> ``TorchTemporalEngine``, resnet ->
    ``TorchResNetEngine``, anything else -> ``TorchYoloEngine`` (YOLOv8).
    A ``.rvae`` artifact -> the exported engine of the same family, which
    refuses an artifact of another family."""
    if str(config.model_path).endswith(".rvae"):
        from .export import ExportedResNetEngine, ExportedTemporalEngine, ExportedYoloEngine

        if config.model_type in TEMPORAL_MODEL_TYPES:
            return ExportedTemporalEngine(config)
        if config.model_type == "resnet":
            return ExportedResNetEngine(config)
        return ExportedYoloEngine(config)
    if config.model_type in TEMPORAL_MODEL_TYPES:
        from .temporal import TorchTemporalEngine

        return TorchTemporalEngine(config)
    if config.model_type == "resnet":
        return TorchResNetEngine(config)
    if config.backend not in ("torch", "cuda"):
        logger.info(
            "backend '%s' requested — serving it with the PyTorch engine",
            config.backend,
        )
    return TorchYoloEngine(config)
