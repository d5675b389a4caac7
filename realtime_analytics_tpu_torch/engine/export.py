"""Serving artifacts: every serving step of an engine as ``torch.export``
programs and its weights, in one ``.rvae`` file.

Counterpart of ``realtime_analytics_tpu/engine/export.py``, the analog of
the reference's prebuilt TensorRT ``.engine`` files (reference
detector.py:382-466). ``export_serving_artifact`` traces an engine's
production serving step for an explicit set of (source resolution x batch
bucket) programs and packs them, with the weights, into one zip. Every
engine family exports:

* YOLO (``TorchYoloEngine``): pad/letterbox -> forward -> decode -> NMS ->
  un-letterbox, per (resolution x bucket), in the host-select ("sel") or
  device-letterbox ("full") variant;
* ResNet classification (``TorchResNetEngine``): the host-resized ("rsz")
  or device-resize ("full") classify step -> top-K;
* temporal clip models (``TorchTemporalEngine``): the clip step over
  [B, T, H, W, 3] windows ("rsz"/"full").

A program is the engine's own step code traced by ``torch.export`` (non
strict), with every kernel routed through its registered ``rva`` op
(``ops/_cuda.py``), so the graph keeps B1 (row gather), B2 (head decode),
B3 (fused stem), B4 (letterbox) and B6 (NMS keep pass) as one node each and
a replayed program launches them (and counts the launches). A program
holds no weights: it takes them as inputs, the model bound to them with
``torch.func.functional_call``, so the weights are stored once for all
programs. Everything the live engine prepares once is an input as well,
never recomputed per step: the engine's ``prepared_state`` (the folded
stem, BGR and /255, B3's packed operands, int8 weights and calibrated
scales, the class mask, the temporal normalisation, B4's tables). The
trace runs the step of a copy of the engine ``bind``-ed to the inputs, so
the engine itself is not touched, and an export that finds a tensor of
more than a few elements baked into a program fails.

The ``Exported*Engine`` classes serve from the artifact alone: no
checkpoint parsing, no model construction, no int8 calibration. Each
inherits its live engine's whole host path (pixel pick, host resize,
grouping, bucket choice, tiling merge, clip buffering) and replaces only
where the device step comes from.

Artifact layout (zip), as the JAX package's:

    meta.json                        format/engine/config echo + program index
    params/<flat-key>.bin            raw little-endian tensor bytes
    programs/<H>x<W>_b<B>_<kind>.pt2 one torch.export.save'd program
                                     (programs/<platform>/... with several)

``params/`` keys use the JAX package's flat key scheme (``a/b/#0/c``, dict
keys percent-escaped; ``_flatten_params``): ``model/<state-dict name>`` for
the module's parameters and buffers and ``prep/...`` for the prepared
state. ``meta.json`` has the JAX package's fields, with ``framework:
"torch"`` and ``torch_version`` in place of ``jax_version``, and each
program's platform, file and input keys. A JAX-made ``.rvae`` (its programs
are ``jax.export`` bytes) is refused by name.

Platforms (``platforms=``, the CLI's ``--platforms``, as the JAX
package's): ``cuda`` and ``cpu``, by default the engine's own device type.
``torch.export`` bakes in the device of its example inputs and the
``rva`` ops dispatch by device, so each platform gets its own programs,
traced on a twin of the engine that lives on that device (its model and
prepared state copied there, and the device's own rules: the fused neck on
the card only): the card's programs launch the kernels, the CPU's run
their plain versions. The weights are written once: a tensor that both
platforms' programs read is one ``params/`` entry. Serving takes the
current device type's programs and refuses an artifact without them, in
the JAX package's words. An artifact of one platform keeps the layout of
the package's earlier artifacts (``device`` in ``meta.json``, programs at
``programs/<name>.pt2``), which also still serve, as one-platform ones.

Wire-in: ``detector.model_path: something.rvae`` routes ``create_detector``
to the exported engine matching ``model_type``; export with the
``realtime-analytics-torch-export`` CLI (scripts/export_engine.py).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import itertools
import json
import logging
import os
import tempfile
import zipfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ConfigError, DetectorConfig
# each kernel module registers its rva:: op, which the loaded programs call
from ..ops import _cuda, decode, gather, letterbox, nms, stem  # noqa: F401
from .detector import (
    TorchResNetEngine,
    TorchYoloEngine,
    fp32_means_fp32,
    fuse_neck_on,
    pick_device,
    to_graph_device,
)
from .temporal import ClipStaging, ClipStats, TorchTemporalEngine

logger = logging.getLogger(__name__)

FORMAT_VERSION = 1
ARTIFACT_SUFFIX = ".rvae"
# a program may hold tensor constants of at most this many elements (the
# scalars a step makes); anything larger is state that escaped its inputs
_MAX_CONSTANT_NUMEL = 16


# -- params (de)hydration (copies of the JAX package's helpers) ---------------


def _esc_key(k: str) -> str:
    """Percent-escape the segment separators in a dict key. Native
    checkpoint trees never need this, but graph-backed engines carry raw
    ONNX initializer names — torch 2.x constant-folded exports produce
    '/'-scoped names like '/model.22/Constant_output_0'."""
    return k.replace("%", "%25").replace("/", "%2F").replace("#", "%23")


def _unesc_key(k: str) -> str:
    return k.replace("%2F", "/").replace("%23", "#").replace("%25", "%")


def _flatten_params(params, prefix: str = "") -> Dict:
    """Nested dict/list-of-arrays -> {'a/b/#0/c': array}. List nodes use
    '#<i>' segment keys so unflatten can rebuild them as lists (dict keys
    in YOLO param trees are layer-index strings, which would collide with
    bare integer segments). Dict keys containing '/', '#', or '%' are
    percent-escaped (ONNX initializer names in graph-backed engines).
    Torch tensors stay tensors (numpy has no bf16); other leaves become
    numpy arrays."""
    flat: Dict = {}
    if isinstance(params, dict):
        for k, v in params.items():
            flat.update(_flatten_params(v, f"{prefix}{_esc_key(str(k))}/"))
        return flat
    if isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            flat.update(_flatten_params(v, f"{prefix}#{i}/"))
        return flat
    arr = params if isinstance(params, torch.Tensor) else np.asarray(params)
    if arr.dtype == object:
        raise ValueError(f"param leaf {prefix[:-1]!r} is not an array")
    flat[prefix[:-1]] = arr
    return flat


def _unflatten_params(flat: Dict) -> Dict:
    out: Dict = {}
    for key, arr in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        # raw '#<i>' segments only come from the list encoding: escaped
        # dict keys never start with '#' ('#' -> '%23'); unescape AFTER
        # the list test so a literal '#foo' dict key cannot masquerade
        if node and all(k.startswith("#") for k in node):
            return [rebuild(node[k]) for k in sorted(node, key=lambda s: int(s[1:]))]
        return {_unesc_key(k): rebuild(v) for k, v in node.items()}

    return rebuild(out)


def _tensor_bytes(t: torch.Tensor) -> bytes:
    """A tensor's values, row-major, as little-endian bytes."""
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _tensor_from(data: bytes, spec: Dict, device: torch.device) -> torch.Tensor:
    dtype = getattr(torch, spec["dtype"])
    if data:
        t = torch.frombuffer(bytearray(data), dtype=torch.uint8).view(dtype)
    else:
        t = torch.empty(0, dtype=dtype)
    t = t.reshape(spec["shape"]).to(device)
    if spec.get("channels_last"):
        t = t.contiguous(memory_format=torch.channels_last)
    return t


def _spec_of(t: torch.Tensor) -> Dict:
    return {"dtype": str(t.dtype).replace("torch.", ""), "shape": list(t.shape),
            "channels_last": bool(t.dim() == 4 and not t.is_contiguous()
                                  and t.is_contiguous(memory_format=torch.channels_last))}


# -- the programs' inputs -------------------------------------------------------


def _engine_kind(engine) -> str:
    # isinstance order matters: exported engines subclass the live ones
    # (re-export of an exported engine is refused — it has no model code)
    if isinstance(engine, _ArtifactMixin):
        raise ValueError("cannot re-export an artifact-served engine")
    if isinstance(engine, TorchYoloEngine):
        return "yolo"
    if isinstance(engine, TorchResNetEngine):
        return "resnet"
    if isinstance(engine, TorchTemporalEngine):
        if engine.config.model_type == "mvitv2_s":
            raise ValueError("model_type mvitv2_s is not exported: its clip step is served "
                             "live (TorchTemporalEngine), not from an artifact")
        return "temporal"
    raise ValueError(f"unsupported engine type {type(engine).__name__}")


def _program_inputs(engine, own_srcs: Sequence[Tuple[int, int]]) -> Dict[str, torch.Tensor]:
    """A program's inputs, flat: the model's parameters and buffers under
    ``model/`` and the engine's prepared state, with B4's tables of
    ``own_srcs``, under ``prep/``."""
    model = engine.model
    tree = {"model": {**dict(model.named_parameters()), **dict(model.named_buffers())},
            "prep": engine.prepared_state(own_srcs)}
    return {k: v.detach() for k, v in _flatten_params(tree).items()}


def _twin(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` that shares its parameters and buffers: a trace
    calls the twin, whose tensors ``functional_call`` swaps for the
    program's inputs and whose graph plans are its own, so the engine's
    module, which may serve meanwhile, is not touched."""
    shared = {id(t): t for t in itertools.chain(module.parameters(), module.buffers())}
    return copy.deepcopy(module, memo=shared)


class _FunctionalModel:
    """A model bound to traced weights: a call is
    ``torch.func.functional_call`` of the module on ``state``; attributes
    are the module's."""

    def __init__(self, module: torch.nn.Module, state: Dict[str, torch.Tensor]):
        self._module, self._state = module, state

    def __call__(self, *args, **kwargs):
        return torch.func.functional_call(self._module, self._state, args, kwargs)

    def __getattr__(self, name):
        return getattr(self._module, name)


class _Program(torch.nn.Module):
    """One serving step as a module with no weights of its own:
    ``forward(inputs, x)`` runs ``step`` of the engine bound to ``inputs``
    on ``x``, with every kernel routed through its op."""

    def __init__(self, engine, step: Callable):
        super().__init__()
        # not submodules: their weights are the program's inputs
        self.__dict__.update(engine=engine, step=step, twin=_twin(engine.model))

    def forward(self, inputs: Dict[str, torch.Tensor], x: torch.Tensor):
        tree = _unflatten_params(inputs)
        model = _FunctionalModel(self.twin, tree["model"])
        bound = self.engine.bind(model, tree.get("prep", {}))
        graph = getattr(model, "_fn", None)  # a graph-backed twin's planned graph
        with graph.scratch_plans() if graph is not None else contextlib.nullcontext(), \
                _cuda.through_ops():
            return tuple(self.step(bound, x))


def _holds_no_state(ep, name: str, graph_backed: bool) -> None:
    """Raise when a traced program keeps a tensor of its own: a weight or
    prepared tensor that the step read from somewhere else than its
    inputs, which every program would then carry. A graph-backed model's
    program keeps the graph's own constants (its ONNX Constant nodes and
    what the plan folds from them: code of the graph, not weights, which
    are initializers and so inputs); for it only the module state is
    checked."""
    consts = {} if graph_backed else ep.constants
    own = {k: tuple(t.shape) for k, t in {**ep.state_dict, **consts}.items()
           if isinstance(t, torch.Tensor) and t.numel() > _MAX_CONSTANT_NUMEL}
    if own:
        raise ValueError(f"program {name} holds tensors that are not its inputs: {own} — "
                         "an engine's prepared_state must list every tensor its steps read")


def _program_name(src_hw: Tuple[int, int], batch: int, kind: str) -> str:
    return f"{src_hw[0]}x{src_hw[1]}_b{batch}_{kind}"


def _program_file(name: str, platform: str, several: bool) -> str:
    return f"programs/{platform}/{name}.pt2" if several else f"programs/{name}.pt2"


def _program_for(engine, src_hw: Tuple[int, int], batch: int):
    """(step on the device input, input shape, kind tag) for one program:
    the engine's step of the key it serves the batch under, with the same
    host-prepare decision."""
    key = engine._step_key(batch, src_hw, engine._host_prepares(src_hw))
    tag = key[-1] if isinstance(key[-1], str) else "full"
    return (lambda eng, x: eng._step_fn(key)[0](x)), engine._step_fn(key)[1], tag


def _graph_backed(engine) -> bool:
    return bool(getattr(engine, "_graph_backed", False)
                or getattr(getattr(engine, "model", None), "graph_backed", False))


PLATFORMS = ("cuda", "cpu")


def export_platforms(platforms: Optional[Sequence[str]], default: str) -> List[str]:
    """The platforms an export asks for (None: ``[default]``), checked:
    ``tpu`` is refused by name, ``cuda`` needs a visible card."""
    out = list(dict.fromkeys(str(p).strip().lower() for p in (platforms or [default])))
    for p in out:
        if p == "tpu":
            raise ValueError("platform 'tpu': TPU programs are the JAX package's "
                             "(realtime_analytics_tpu.scripts.export_engine); the PyTorch "
                             f"package exports for {', '.join(PLATFORMS)}")
        if p not in PLATFORMS:
            raise ValueError(f"unknown platform {p!r}: the PyTorch package exports for "
                             f"{', '.join(PLATFORMS)}")
        if p == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("platform 'cuda' needs a CUDA card to trace its programs and "
                               "none is visible: export with --platforms cpu here, and the "
                               "card's programs on a machine with one")
    return out


def _to_device(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _platform_engine(engine, platform: str, srcs: Sequence[Tuple[int, int]]):
    """``engine`` on ``platform``'s device: itself when it is there, else a
    twin whose model and prepared state (B4's tables of ``srcs`` included)
    are copies on that device, under that device's rules. The twin's
    tensors hold the engine's values, so both platforms' programs read the
    same weights."""
    if platform == engine.device.type:
        return engine
    dev = (torch.device("cpu") if platform == "cpu"
           else torch.device("cuda", torch.cuda.current_device()))
    model = copy.deepcopy(engine.model)
    if _graph_backed(engine):
        to_graph_device(model, dev)
    else:
        model.to(dev)
    if isinstance(engine, TorchYoloEngine) and not _graph_backed(engine):
        model.fuse_neck = fuse_neck_on(dev)
        if model.fuse_neck:
            model.prepare_neck()
    twin = engine.bind(model, _to_device(engine.prepared_state(srcs), dev))
    twin.device = dev
    return twin


def export_serving_artifact(
    engine,
    path: str,
    src_hws: Sequence[Tuple[int, int]],
    buckets: Optional[Sequence[int]] = None,
    platforms: Optional[Sequence[str]] = None,
) -> Dict:
    """Trace ``engine``'s serving step for every (src_hw x bucket) on each
    of ``platforms`` (``cuda``, ``cpu``; default: the engine's device type)
    and write the self-contained artifact to ``path``. Returns the meta dict
    (also in the artifact). The artifact serves only on the device types it
    was exported for, as a TensorRT engine is bound to its card."""
    kind = _engine_kind(engine)
    if getattr(engine, "mesh", None) is not None:
        raise ValueError(
            "export_serving_artifact supports single-device engines; a mesh engine "
            "runs its steps over the mesh's devices, which a program traced for one "
            "device does not hold: serve the checkpoint with mesh_shape")
    if not str(path).endswith(ARTIFACT_SUFFIX):
        raise ValueError(f"artifact path must end with {ARTIFACT_SUFFIX}")
    # dedupe after normalization (order-preserving): repeated sources must
    # not produce duplicate zip entries or index rows
    src_hws = list(dict.fromkeys((int(h), int(w)) for h, w in src_hws))
    if not src_hws:
        raise ValueError("src_hws must name at least one source resolution")
    # tiled YOLO serving runs the input-sized step on the tile crops (the
    # live warmup recurses into input_hw for the same reason)
    if kind == "yolo" and engine.config.tiling and tuple(engine.input_hw) not in src_hws:
        src_hws.append(tuple(engine.input_hw))
    buckets = sorted(set(buckets or engine.config.resolved_buckets))
    plans, flat = {}, {}
    for platform in export_platforms(platforms, engine.device.type):
        eng = _platform_engine(engine, platform, src_hws)
        plans[platform] = (eng, [(src_hw, b, *_program_for(eng, src_hw, b))
                                 for src_hw in src_hws for b in buckets])
        inputs = _program_inputs(eng, list(dict.fromkeys(
            src for src, _, _, _, tag in plans[platform][1] if tag == "full")))
        for key, t in inputs.items():
            if key in flat and not torch.equal(flat[key].cpu(), t.cpu()):
                raise ValueError(f"{key} differs between the platforms' engines")
            flat.setdefault(key, t)

    # write to a temp file and rename on success: a failed export must not
    # leave a structurally-valid-looking partial zip at the target
    fd, tmp_path = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)) or ".",
                                    suffix=ARTIFACT_SUFFIX + ".tmp")
    os.close(fd)
    try:
        _write_artifact_zip(tmp_path, engine, kind, plans, flat)
        os.replace(tmp_path, path)
    except BaseException:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        raise
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
    logger.info("wrote %s: %d program(s), %d weight tensors", path, len(meta["programs"]),
                len(flat))
    return meta


def _write_artifact_zip(path, engine, kind, plans, flat) -> None:
    cfg = engine.config
    programs: List[Dict] = []
    several = len(plans) > 1
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for key, t in flat.items():
            zf.writestr(f"params/{key}.bin", _tensor_bytes(t))
        for platform, (eng, steps) in plans.items():
            # 'rsz' steps take input_hw-shaped batches whatever the source,
            # so one program per bucket serves every source: write it once
            # and alias later index rows to it
            shared_rsz: Dict[int, Tuple[str, List[int], List[str]]] = {}
            for src_hw, b, step, in_shape, tag in steps:
                if tag == "rsz" and b in shared_rsz:
                    name, shape, keys = shared_rsz[b]
                else:
                    inputs = _program_inputs(eng, [src_hw] if tag == "full" else [])
                    keys = list(inputs)
                    x = torch.zeros(in_shape, dtype=torch.uint8, device=eng.device)
                    name = _program_name(src_hw, b, tag)
                    with torch.no_grad():
                        ep = torch.export.export(_Program(eng, step), (inputs, x),
                                                 strict=False)
                    _holds_no_state(ep, name, _graph_backed(eng))
                    ep.example_inputs = None  # else the weights would be saved with it
                    buf = io.BytesIO()
                    torch.export.save(ep, buf)
                    shape = list(in_shape)
                    zf.writestr(_program_file(name, platform, several), buf.getvalue())
                    if tag == "rsz":
                        shared_rsz[b] = (name, shape, keys)
                programs.append({"src_h": src_hw[0], "src_w": src_hw[1], "batch": b,
                                 "kind": tag, "in_shape": shape, "name": name,
                                 "platform": platform,
                                 "file": _program_file(name, platform, several),
                                 "inputs": keys})
                logger.info("exported %s (platform=%s)", name, platform)
        meta = {
            "format_version": FORMAT_VERSION,
            "engine": kind,
            "framework": "torch",
            "torch_version": torch.__version__,
            "platforms": list(plans),
            # one platform: the earlier artifacts' layout, which names it so
            **({} if several else {"device": next(iter(plans))}),
            "model_type": cfg.model_type,
            "input_size": list(engine.input_hw),
            "precision": cfg.precision,
            "confidence_threshold": cfg.confidence_threshold,
            "iou_threshold": cfg.iou_threshold,
            "max_detections": cfg.max_detections,
            "host_select": cfg.host_select,
            "host_resize": cfg.host_resize,
            # graph-backed engines export only 'full' programs (no stem to
            # fold): serve-time host_prepare must agree
            "graph_backed": _graph_backed(engine),
            "graph_precision": cfg.graph_precision,
            "classes": list(cfg.classes) if cfg.classes else None,
            "sequence_length": cfg.sequence_length,
            "resnet_top_k": cfg.resnet_top_k,
            "resnet_scores": cfg.resnet_scores,
            "params": {k: _spec_of(t) for k, t in flat.items()},
            "programs": programs,
        }
        zf.writestr("meta.json", json.dumps(meta, indent=1))


# -- serving -------------------------------------------------------------------


class _ArtifactMixin:
    """Shared .rvae loading and program plumbing of the exported engines."""

    def _init_artifact(self, config: DetectorConfig, expected_engine: str) -> None:
        self.config = config
        if config.mesh_shape:
            raise ConfigError(
                "mesh_shape cannot be served from a .rvae artifact: its programs are "
                "traced for one device at export time. For mesh serving point "
                "model_path at the checkpoint")
        self.device = pick_device(config)
        # TF32 off for fp32: process state that an exported program does not carry
        fp32_means_fp32(self.device)
        path = config.model_path
        with zipfile.ZipFile(path) as zf:
            meta = json.loads(zf.read("meta.json"))
            if "jax_version" in meta or meta.get("framework") != "torch":
                raise ConfigError(
                    f"{path} is a JAX-made .rvae (jax_version "
                    f"{meta.get('jax_version')!r}): its programs are jax.export bytes, "
                    "which the PyTorch package cannot run — re-export the model with "
                    "realtime-analytics-torch-export")
            if meta.get("format_version") != FORMAT_VERSION:
                raise ConfigError(f"{path}: unsupported artifact format "
                                  f"{meta.get('format_version')!r} (expected {FORMAT_VERSION})")
            if meta.get("engine") != expected_engine:
                raise ConfigError(
                    f"{path}: artifact serves a '{meta.get('engine')}' engine, but "
                    f"model_type '{config.model_type}' needs '{expected_engine}'")
            here = self.device.type
            # a one-platform artifact (the earlier layout included) names it
            # as ``device``
            platforms = [meta["device"]] if "device" in meta else meta["platforms"]
            if here not in platforms:
                raise ConfigError(
                    f"{path}: exported for platforms {platforms}, current device is "
                    f"'{here}' — re-export on this platform, i.e. re-export on this device "
                    f"with --platforms {here}")
            rows = [p for p in meta["programs"] if p.get("platform", here) == here]
            keys = {k for p in rows for k in p["inputs"]}
            self._params = {key: _tensor_from(zf.read(f"params/{key}.bin"), spec, self.device)
                            for key, spec in meta["params"].items() if key in keys}
        if not rows:
            raise ConfigError(f"{path}: artifact contains no serving programs — re-export "
                              "with at least one source resolution")
        self.meta = meta
        self._programs = {(p["src_h"], p["src_w"], p["batch"], p["kind"]): p for p in rows}
        # loaded programs by name, each with its inputs; _steps holds the
        # runnable step of each key, as the live engine's
        self._loaded_programs: Dict[str, Tuple[Callable, Dict[str, torch.Tensor]]] = {}
        self.input_hw = (int(meta["input_size"][0]), int(meta["input_size"][1]))
        self._graph_backed = bool(meta.get("graph_backed", False))
        if list(config.resolved_input_size) != list(self.input_hw):
            logger.warning(
                "detector.input_size %s != artifact input_size %s — the artifact wins "
                "(its geometry is traced into the programs)",
                list(config.resolved_input_size), list(self.input_hw))
        # the knobs traced into the programs differ per family: YOLO
        # thresholds, NMS and the class mask; ResNet top-K and the score
        # head; temporal nothing beyond the clip geometry
        baked = {"yolo": ("confidence_threshold", "iou_threshold", "max_detections",
                          "classes"),
                 "resnet": ("resnet_top_k", "resnet_scores"),
                 "temporal": ()}[expected_engine]
        for knob in baked:
            mine, theirs = getattr(config, knob), meta.get(knob)
            if knob == "classes":
                mine, theirs = sorted(mine) if mine else None, sorted(theirs) if theirs else None
            if mine != theirs:
                logger.warning(
                    "detector.%s=%s differs from the artifact's traced-in %s — these "
                    "are part of the exported programs; re-export to change them",
                    knob, getattr(config, knob), meta.get(knob))
        self._init_steps()
        # the bucket machinery (batcher max_batch, clip flush target,
        # warmup) tracks the artifact's buckets, and the host-prepare
        # decision traced into each program's input shape tracks export's
        buckets = sorted({p["batch"] for p in rows})
        self.config = dataclasses.replace(
            config, batch_buckets=buckets, max_batch_size=buckets[-1],
            host_select=meta["host_select"], host_resize=meta["host_resize"])

    def _buckets(self, src_hw: Tuple[int, int]) -> List[int]:
        """The exported buckets of ``src_hw`` (an 'rsz' program serves every
        source): the only ones warmup and the bucket choice may run."""
        avail = sorted({b for (h, w, b, kind) in self._programs
                        if (h, w) == tuple(src_hw) or kind == "rsz"})
        if not avail:
            raise ConfigError(self._missing(src_hw))
        return avail

    def _effective_bucket(self, n: int, src_hw: Tuple[int, int]) -> int:
        """The live engines run an oversized batch as it is; an artifact
        cannot: fail with the designed message."""
        bucket = super()._effective_bucket(n, src_hw)
        if n > bucket:
            raise ValueError(f"batch {n} exceeds the largest exported bucket {bucket} "
                             f"for {tuple(src_hw)} in {self.config.model_path}")
        return bucket

    def _missing(self, src_hw, batch=None, kind=None) -> str:
        have = ", ".join(sorted({p["name"] for p in self._programs.values()}))
        want = (_program_name(tuple(src_hw), batch, kind) if batch is not None
                else f"{src_hw[0]}x{src_hw[1]}")
        return (f"{self.config.model_path} has no program for {want} (exported: {have}) "
                "— re-export with this resolution/bucket")

    def _rsz_program_src(self, batch: int) -> Tuple[int, int]:
        """Source of any exported 'rsz' program of this bucket: the resized
        step's input is already input_hw, so it serves every source."""
        for (h, w, b, kind) in sorted(self._programs):
            if b == batch and kind == "rsz":
                return (h, w)
        raise ConfigError(self._missing(("any", "any"), batch, "rsz"))

    def _run_program(self, src_hw: Tuple[int, int], x: torch.Tensor, kind: str):
        """Run the exported program of (src_hw, x's batch, kind) on x."""
        batch = int(x.shape[0])
        if kind == "rsz":
            src_hw = self._rsz_program_src(batch)
        key = (int(src_hw[0]), int(src_hw[1]), batch, kind)
        if key not in self._programs:
            raise ConfigError(self._missing(src_hw, batch, kind))
        entry = self._programs[key]
        hit = self._loaded_programs.get(entry["name"])
        if hit is None:
            with zipfile.ZipFile(self.config.model_path) as zf:
                data = zf.read(entry.get("file", f"programs/{entry['name']}.pt2"))
            program = torch.export.load(io.BytesIO(data)).module()
            inputs = {k: self._params[k] for k in entry["inputs"]}
            out = program(inputs, x)  # checks every input against the program's
            # later calls pass the same weight tensors and a batch of this
            # key's shape: the per-call check of ~250 inputs (host time the
            # host-bound steps pay in full) is not repeated
            program.validate_inputs = False
            self._loaded_programs[entry["name"]] = (program, inputs)
            return out
        program, inputs = hit
        return program(inputs, x)


class ExportedYoloEngine(_ArtifactMixin, TorchYoloEngine):
    """Serve YOLO detection from a ``.rvae`` artifact: the host path (pixel
    pick, host resize, grouping, bucket choice, tiling merge) is
    ``TorchYoloEngine``'s; the device step is the artifact's program. Only
    the exported (resolution x bucket) programs can run — another shape
    raises with the list of those exported (a TensorRT engine's contract).
    The steps are cached as the live engine's, under its keys: on the card
    the loaded program captured as a CUDA graph after its first, checked
    call (``engine/graphs.py``), as the JAX exported engine keeps
    ``jax.jit(exported.call)`` in ``_steps``."""

    def __init__(self, config: DetectorConfig):
        config.validate()
        self._init_artifact(config, "yolo")
        self.class_agnostic_nms = True  # the tiling merge's, as the live engine's

    def _step_selected(self, sel_u8: torch.Tensor, spec):
        return self._run_program((spec.src_h, spec.src_w), sel_u8, "sel")

    def _step_device_resize(self, frames_u8: torch.Tensor, spec):
        return self._run_program((spec.src_h, spec.src_w), frames_u8, "full")


class ExportedResNetEngine(_ArtifactMixin, TorchResNetEngine):
    """Serve ResNet classification from a ``.rvae`` artifact (host resize,
    grouping and bucket choice are ``TorchResNetEngine``'s)."""

    def __init__(self, config: DetectorConfig):
        config.validate()
        self._init_artifact(config, "resnet")

    def _step(self, frames_u8: torch.Tensor, resized: bool):
        return self._run_program(tuple(frames_u8.shape[1:3]), frames_u8,
                                 "rsz" if resized else "full")


class ExportedTemporalEngine(_ArtifactMixin, TorchTemporalEngine):
    """Serve temporal clip models from a ``.rvae`` artifact: the clip
    buffering, stride and overlap contract is ``TorchTemporalEngine``'s;
    only the clip step comes from the artifact."""

    def __init__(self, config: DetectorConfig):
        config.validate()
        self._init_artifact(config, "temporal")
        if self.meta["sequence_length"] != self.config.sequence_length:
            logger.warning(
                "detector.sequence_length=%s differs from the artifact's %s — the "
                "artifact wins (clip length is traced into the programs)",
                self.config.sequence_length, self.meta["sequence_length"])
            self.config = dataclasses.replace(
                self.config, sequence_length=self.meta["sequence_length"])
        self.sequence_step = max(
            1, int(self.config.sequence_length * (1.0 - self.config.temporal_overlap)))
        self._buffers = {}
        self._warned_no_cv2 = False
        self.stats = ClipStats()
        self._staging = ClipStaging(self.device.type == "cuda")

    def _step(self, clips_u8: torch.Tensor, resized: bool):
        return self._run_program(tuple(clips_u8.shape[2:4]), clips_u8,
                                 "rsz" if resized else "full")
