"""Graph-backed model adapters: serve an arbitrary user ONNX file.

Counterpart of ``realtime_analytics_tpu/models/onnx_graph_model.py``. The
reference's ONNX Runtime / OpenVINO backends execute whatever graph the
user exported (reference detector.py:484-609; temporal_detector.py:179-319)
— the architecture never has to match anything the framework knows. The
named loaders in ``models/weights.py`` cover the documented checkpoint
layouts; these adapters cover the rest: when a ``.onnx`` matches no known
layout, the engines serve the **graph itself** through
``models/onnx_torch.py`` inside their usual steps (device letterbox,
forward, NMS).

Batch handling. torch exports come in two shapes:

* **dynamic-batch** exports: batch-dependent reshape targets arrive as
  Shape->Gather->Concat subgraphs, which ``onnx_torch`` folds against the
  serving shape when it plans — every bucket plans correctly.
* **static-batch** exports (e.g. a stock Ultralytics ``yolov8n.onnx``,
  batch 1 baked into every Reshape constant): the adapter detects this
  with a probe at a batch the export cannot have used, and serves through
  ``torch.func.vmap`` over the batch-1 plan — the convolutions still see
  the whole bucket.

The probe runs the graph on the ``meta`` device: tensors with shapes and
dtypes and no data, so no operation is computed, the probe of a full-width
YOLOv8n costs what its planning costs, and it cannot read a value any more
than JAX's ``jax.eval_shape`` can (a graph whose float initializer feeds a
shape position fails the probe as it would fail the first live batch).

Weights: an adapter is an ``nn.Module`` whose float initializers (and
int8 weights used only at quantized-weight positions) are buffers, so
``.to(device)`` moves them; shape-machinery tensors (int tensors, Resize
scales, Range bounds) stay numpy constants so the folding above works.
Graphs serve in fp32 by default (a foreign graph's numerics are the user's
contract); ``detector.graph_precision: bf16`` opts into the mixed policy
(``onnx_torch.graph_compute_dtype``), the analog of the reference building
an FP16 TensorRT engine from a user's fp32 ONNX (detector.py:382-466).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .onnx_exec import UnsupportedOnnxOp, _eval_node
from .onnx_lite import OnnxGraph, read_onnx_model
from .onnx_torch import compile_graph, graph_compute_dtype, to_torch

logger = logging.getLogger(__name__)

# a batch size no sane export was traced at — used to probe batch dynamism
_PROBE_BATCH = 3


def graph_dtype(graph_precision: str) -> torch.dtype:
    """Map ``detector.graph_precision`` to the adapters' ``compute_dtype``
    (config validation already rejects other values)."""
    return torch.bfloat16 if graph_precision == "bf16" else torch.float32


def fold_constants(g: OnnxGraph) -> OnnxGraph:
    """Load-time partial evaluation: every node computable purely from
    initializers (no graph-input dependency) collapses into an initializer
    through the numpy executor.

    The payoff is quantized exports: torch's fake-quant QDQ exporter leaves
    weights fp32 with a runtime ``QuantizeLinear`` pair (``w_f32 -> Q -> DQ
    -> Conv``); folding the ``Q`` leaves ``w_int8 -> DQ -> Conv``, which
    ``serving_params`` keeps on the device at one byte per element. Also
    sweeps Constant nodes and attribute-math chains out of the graph."""
    values: dict = dict(g.initializers)
    graph_inputs = set(g.inputs)
    remaining = []
    for node in g.nodes:
        foldable = all((not i) or (i in values) for i in node.inputs) and \
            not any(i in graph_inputs for i in node.inputs)
        if foldable and node.op_type == "DequantizeLinear" and np.asarray(
            values[node.inputs[0]]
        ).dtype in (np.dtype(np.int8), np.dtype(np.uint8)):
            # the int8 -> fp32 barrier: folding it would re-materialize the
            # fp32 weight; kept live, the weight stays int8 on the device
            foldable = False
        if foldable:
            try:
                tmp = {"": None}
                tmp.update({i: values[i] for i in node.inputs if i})
                _eval_node(node, tmp)
            except Exception:  # noqa: BLE001 — leave it to the live path
                remaining.append(node)
                continue
            for o in node.outputs:
                if o and o in tmp:
                    values[o] = np.asarray(tmp[o])
        else:
            remaining.append(node)
    used = set(g.outputs)
    for n in remaining:
        used.update(n.inputs)
    n_folded = len(g.nodes) - len(remaining)
    if n_folded:
        logger.info("ONNX load: folded %d constant node(s)", n_folded)
    return OnnxGraph(
        nodes=remaining,
        initializers={k: v for k, v in values.items() if k in used},
        inputs=g.inputs,
        outputs=g.outputs,
    )


# quantized-op operand positions where an int8/uint8 initializer is a WEIGHT
# (kept on the device at one byte per element); zero points sit at other
# positions and stay numpy constants
_QUANT_WEIGHT_POSITIONS = {
    "DequantizeLinear": (0,),
    "ConvInteger": (0, 1),
    "MatMulInteger": (0, 1),
    "QLinearConv": (0, 3),
    "QLinearMatMul": (0, 3),
}

# float operand positions that are quantization SCALES: the model's
# numerics, never a precision knob — they keep fp32 under any bf16 cast
# (a bf16-truncated scale shifts the quantization grid itself)
_QUANT_SCALE_POSITIONS = {
    "QuantizeLinear": (1,),
    "DequantizeLinear": (1,),
    "QLinearConv": (1, 4, 6),
    "QLinearMatMul": (1, 4, 6),
}


def quant_scale_param_names(g: OnnxGraph) -> frozenset:
    """Initializer names consumed at quantization-scale positions."""
    names = set()
    for node in g.nodes:
        for pos in _QUANT_SCALE_POSITIONS.get(node.op_type, ()):
            if pos < len(node.inputs) and node.inputs[pos] in g.initializers:
                names.add(node.inputs[pos])
    return frozenset(names)


def cast_params_for_compute(params: Dict[str, torch.Tensor], compute_dtype: torch.dtype,
                            fp32_names=frozenset()) -> Dict[str, torch.Tensor]:
    """Params cast to the compute dtype, except quantization scales
    (``fp32_names``) and non-float tensors."""
    return {k: v.to(compute_dtype) if v.is_floating_point() and k not in fp32_names else v
            for k, v in params.items()}


def serving_params(g: OnnxGraph) -> Dict[str, np.ndarray]:
    """Initializers that are safe to feed as live params: float tensors
    (weights), except anything consumed as a shape or scale argument
    (Resize scales/sizes, Range bounds, ConstantOfShape shape, a Pad
    constant), which must stay numpy for the folding in ``onnx_torch``;
    plus int8/uint8 weights consumed ONLY at quantized-op weight positions.
    Other int tensors stay constant (Reshape/Slice/Split arguments, zero
    points)."""
    static_names = set()
    for node in g.nodes:
        if node.op_type == "Resize":
            static_names.update(node.inputs[1:])
        elif node.op_type in ("Range", "ConstantOfShape"):
            static_names.update(node.inputs)
        elif node.op_type == "Pad":
            static_names.update(node.inputs[2:3])
    qweights = set()
    for node in g.nodes:  # every use must be a quantized-weight position
        allowed = _QUANT_WEIGHT_POSITIONS.get(node.op_type, ())
        for pos, name in enumerate(node.inputs):
            if name in g.initializers and g.initializers[name].dtype in (
                np.dtype(np.int8), np.dtype(np.uint8),
            ):
                if pos in allowed:
                    qweights.add(name)
                else:
                    static_names.add(name)
    return {
        k: v
        for k, v in g.initializers.items()
        if k not in static_names
        and (np.issubdtype(v.dtype, np.floating) or k in qweights)
    }


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


class OnnxGraphModel(nn.Module):
    """Base adapter: compiled graph, batch-mode probe, params as buffers.

    ``apply(params, x)`` is the functional form (the probes run it on meta
    tensors); ``forward`` applies the module's own buffers."""

    graph_backed = True

    def __init__(self, graph: OnnxGraph, example_shape: Tuple[int, ...],
                 compute_dtype: torch.dtype = torch.float32):
        """``example_shape``: graph-layout input shape WITHOUT the batch
        dim, e.g. (3, 640, 640). ``compute_dtype``: ``torch.float32``
        (exact) or ``torch.bfloat16`` (the mixed policy)."""
        super().__init__()
        if len(graph.inputs) != 1:
            raise UnsupportedOnnxOp(
                f"serving graphs must have exactly one data input, found {graph.inputs}")
        graph = fold_constants(graph)
        self.graph = graph
        self.input_name = graph.inputs[0]
        self.compute_dtype = compute_dtype
        params = serving_params(graph)
        # ONNX names may hold dots, which buffer names may not
        self._buffer_names: Dict[str, str] = {}
        for i, (name, arr) in enumerate(params.items()):
            self._buffer_names[name] = f"p{i}"
            self.register_buffer(f"p{i}", to_torch(arr))
        # quantization scales riding as live params stay fp32 under any cast
        self.fp32_param_names = frozenset(
            n for n in quant_scale_param_names(graph) if n in params)
        self._fn = compile_graph(graph)
        self.example_shape = tuple(int(s) for s in example_shape)
        self.dynamic_batch = self._probe_dynamic()
        logger.info(
            "ONNX graph model: %d nodes, %d param tensors, input '%s' %s, batch mode: %s, "
            "compute %s", len(graph.nodes), len(params), self.input_name,
            self.example_shape,
            "dynamic" if self.dynamic_batch else "vmap (static-batch export)",
            str(compute_dtype).replace("torch.", ""))

    # -- params ---------------------------------------------------------

    def params(self) -> Dict[str, torch.Tensor]:
        """The live params (the buffers), by ONNX name."""
        return {name: getattr(self, buf) for name, buf in self._buffer_names.items()}

    def cast_params(self, compute_dtype: torch.dtype) -> None:
        """Cast the float buffers to ``compute_dtype`` in place, quantization
        scales exempt (``cast_params_for_compute``)."""
        cast = cast_params_for_compute(self.params(), compute_dtype, self.fp32_param_names)
        for name, t in cast.items():
            setattr(self, self._buffer_names[name], t)

    def meta_params(self) -> Dict[str, torch.Tensor]:
        return {k: _meta(v) for k, v in self.params().items()}

    # -- running the graph -------------------------------------------------

    def _probe_dynamic(self) -> bool:
        """True when the export is batch-polymorphic: a meta run at a batch
        the export was not traced at succeeds AND the leading output dim
        follows the batch (a batch-1-baked Reshape would either throw or
        collapse the batch)."""
        x = torch.empty((_PROBE_BATCH, *self.example_shape), device="meta")
        try:
            outs = self._run_direct(self.meta_params(), x)
            return all(o.ndim >= 1 and o.shape[0] == _PROBE_BATCH for o in outs)
        except Exception:  # noqa: BLE001 — any failure = a static export
            return False

    def _run_direct(self, params, x: torch.Tensor) -> List[torch.Tensor]:
        with graph_compute_dtype(self.compute_dtype):
            return self._fn({self.input_name: x, **params})

    def run(self, params, x: torch.Tensor) -> List[torch.Tensor]:
        """The graph on a batched graph-layout input [B, ...]."""
        if self.dynamic_batch:
            return self._run_direct(params, x)
        outs = torch.func.vmap(lambda xi: tuple(self._run_direct(params, xi[None])))(x)
        # each out is [B, 1, ...] (the export's baked batch-1 dim)
        return [o.squeeze(1) if o.ndim >= 2 and o.shape[1] == 1 else o for o in outs]


class OnnxGraphYolo(OnnxGraphModel):
    """Detection adapter: the graph emits the reference's prediction matrix
    (v8: ``[N, 4+nc, A]`` xywh + per-class scores; v5: ``[N, A, 5+nc]`` with
    objectness). Decode follows reference detector.py:266-338, with its v8
    mis-decode fixed as models/yolo.py does (the reference multiplies class
    0 in as objectness whenever cols > 5)."""

    def __init__(self, graph: OnnxGraph, model_type: str, input_hw: Tuple[int, int],
                 compute_dtype: torch.dtype = torch.float32):
        self.model_type = model_type
        self.input_hw = tuple(int(v) for v in input_hw)
        super().__init__(graph, (3, *input_hw), compute_dtype=compute_dtype)
        self._init_end2end()

    def _init_end2end(self) -> None:
        """End-to-end exports embed NMS in the graph. Supported shape: the
        NMS node's ``selected_indices`` is a graph output — the adapter then
        gathers the final boxes and scores from the NMS node's own inputs and
        the engine skips its NMS (``end2end``). Gather glue AFTER the NMS
        node would read the padded static rows (``onnx_torch._nms_padded``)
        as dense rows — rejected loudly instead of mis-serving."""
        self.end2end = False
        nms_nodes = [n for n in self.graph.nodes if n.op_type == "NonMaxSuppression"]
        if not nms_nodes:
            return
        consumed = {i for n in self.graph.nodes for i in n.inputs if i}
        fed = [n for n in nms_nodes if any(o and o in consumed for o in n.outputs)]
        if fed:
            raise UnsupportedOnnxOp(
                "NonMaxSuppression output feeds further graph nodes — its output is "
                "statically padded, so post-NMS gather glue would read pad rows; "
                "re-export with selected_indices as a graph output (torchvision-style) "
                "to serve this file")
        terminal = [n for n in nms_nodes if n.outputs[0] in self.graph.outputs]
        if not terminal:
            raise UnsupportedOnnxOp(
                "NonMaxSuppression node is dead (output neither a graph output nor "
                "consumed) — re-export with selected_indices as a graph output "
                "(torchvision-style) to serve this file")
        if len(terminal) > 1:
            raise UnsupportedOnnxOp(
                f"{len(terminal)} terminal NonMaxSuppression nodes — the adapter can "
                "serve exactly one detection head; re-export with a single NMS whose "
                "selected_indices is the graph output")
        nms = terminal[0]
        self.end2end = True
        self._nms_center = int(nms.attrs.get("center_point_box", 0))
        # boxes / scores as the NMS node saw them: the export's own decoded,
        # pixel-space tensors
        self._fn_e2e = compile_graph(
            self.graph, outputs=[nms.outputs[0], nms.inputs[0], nms.inputs[1]])
        logger.info(
            "ONNX graph model: end-to-end export (graph-embedded NMS, center_point_box=%d) "
            "— engine NMS will be skipped", self._nms_center)

    def _apply_end2end(self, params, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [N, H, W, 3] -> final per-image detections, padded to the
        graph's static NMS bound; pad rows carry conf 0. Boxes follow the
        torch export convention for center_point_box=0 (xyxy corners, either
        diagonal order — normalized here); center_point_box=1 converts from
        [x_c, y_c, w, h]."""
        xg = x.to(self.compute_dtype).permute(0, 3, 1, 2)

        def per_example(xi):
            with graph_compute_dtype(self.compute_dtype):
                sel, bxs, scs = self._fn_e2e({self.input_name: xi[None], **params})
            box_i, cls_i = sel[:, 2], sel[:, 1]
            valid = box_i >= 0
            bi = torch.clamp_min(box_i, 0)
            ci = torch.clamp_min(cls_i, 0)
            b = bxs[0].to(torch.float32)[bi]
            if self._nms_center:
                half = b[:, 2:] * 0.5
                b = torch.cat([b[:, :2] - half, b[:, :2] + half], dim=-1)
            else:
                lo = torch.minimum(b[:, :2], b[:, 2:])
                hi = torch.maximum(b[:, :2], b[:, 2:])
                b = torch.cat([lo, hi], dim=-1)
            s = scs[0].to(torch.float32)[ci, bi]
            return b * valid[:, None], s * valid, ci.to(torch.int32)

        b, s, c = torch.func.vmap(per_example)(xg)
        return {"boxes_xyxy": b, "conf": s, "cls": c}

    def _expected_anchors(self) -> int:
        """Anchor count of a standard 3-level (stride 8/16/32) head at this
        input size — v5 predicts 3 anchors per cell, v8 one. Picks the
        [N, C, A] vs [N, A, C] orientation deterministically."""
        h, w = self.input_hw
        cells = sum((h // s) * (w // s) for s in (8, 16, 32))
        return 3 * cells if self.model_type == "yolov5" else cells

    def apply(self, params, x: torch.Tensor, reduce_scores: bool = False
              ) -> Dict[str, torch.Tensor]:
        """x: [N, H, W, 3] RGB in [0, 1] (the engine's device letterbox)."""
        if self.end2end:
            return self._apply_end2end(params, x)
        pred = self.run(params, x.to(self.compute_dtype).permute(0, 3, 1, 2))[0]
        pred = pred.to(torch.float32)
        if pred.ndim != 3:
            raise UnsupportedOnnxOp(
                f"detection graph output must be [N, C, A] or [N, A, C], got shape "
                f"{tuple(pred.shape)}")
        # orientation: the dim that equals the standard head's anchor count
        # at this input size; else smaller-dim-is-channels
        a_exp = self._expected_anchors()
        d1, d2 = pred.shape[1], pred.shape[2]
        if d2 == a_exp and d1 != a_exp:
            pred = pred.transpose(1, 2)  # [N, C, A] -> [N, A, C]
        elif d1 == a_exp and d2 != a_exp:
            pass  # already [N, A, C]
        elif d1 < d2:
            pred = pred.transpose(1, 2)
        xywh = pred[..., :4]
        if self.model_type == "yolov5":
            scores = pred[..., 4:5] * pred[..., 5:]
        else:
            scores = pred[..., 4:]
        half = xywh[..., 2:] * 0.5
        boxes = torch.cat([xywh[..., :2] - half, xywh[..., :2] + half], dim=-1)
        if reduce_scores:
            return {"boxes_xyxy": boxes, "conf": torch.amax(scores, dim=-1),
                    "cls": torch.argmax(scores, dim=-1).to(torch.int32)}
        return {"boxes_xyxy": boxes, "scores": scores}

    def forward(self, x: torch.Tensor, reduce_scores: bool = False, **_native_only):
        """The engine's call; the native model's stem arguments (``w0``,
        ``stem_weights``) do not apply to a foreign graph."""
        return self.apply(self.params(), x, reduce_scores)


class OnnxGraphTemporal(OnnxGraphModel):
    """Temporal adapter. Input layout per family follows the reference:
    CNN-LSTM / ConvGRU take ``[N, T, C, H, W]`` (temporal_detector.py:
    330-373), 3D-CNN / SlowFast take ``[N, C, T, H, W]`` (:554-593).
    Output: action logits ``[N, num_classes]``."""

    def __init__(self, graph: OnnxGraph, model_type: str, t_len: int,
                 input_hw: Tuple[int, int], compute_dtype: torch.dtype = torch.float32):
        self.channels_first_time = model_type in ("3d_cnn", "slow_fast")
        shape = (3, t_len, *input_hw) if self.channels_first_time else (t_len, 3, *input_hw)
        super().__init__(graph, shape, compute_dtype=compute_dtype)

    def apply(self, params, clips: torch.Tensor) -> torch.Tensor:
        """clips: [N, T, H, W, 3] normalized RGB (the clip head's layout)."""
        perm = (0, 4, 1, 2, 3) if self.channels_first_time else (0, 1, 4, 2, 3)
        return self.run(params, clips.to(self.compute_dtype).permute(perm))[0].to(torch.float32)

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        return self.apply(self.params(), clips)


class OnnxGraphClassifier(OnnxGraphModel):
    """Classification adapter: ``[N, 3, H, W]`` ImageNet-normalized in,
    logits out (reference ResNet-ONNX contract, detector.py:1004-1134)."""

    def __init__(self, graph: OnnxGraph, input_hw: Tuple[int, int],
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(graph, (3, *input_hw), compute_dtype=compute_dtype)

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        """x: [N, H, W, 3] normalized RGB (the engine's classify head)."""
        return self.run(params, x.to(self.compute_dtype).permute(0, 3, 1, 2))[0].to(
            torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.params(), x)


def try_load_graph_model(path: str, kind: str, **kwargs) -> Optional[OnnxGraphModel]:
    """Called by the engines AFTER the named-layout loaders fail: parse
    ``path``, build the ``kind`` adapter ('yolo' / 'temporal' /
    'classifier') and probe its serving call once on the meta device, so an
    unsupported op surfaces here, not at the first live batch. None (with
    the reason logged) when the file is not a usable full graph."""
    if not str(path).endswith(".onnx"):
        return None
    try:
        graph = read_onnx_model(str(path))
    except Exception as exc:  # noqa: BLE001 — unreadable/foreign file
        logger.warning("'%s' did not parse as ONNX: %s", path, exc)
        return None
    if not graph.nodes:
        return None  # a weights-only container: nothing to execute
    cls = {"yolo": OnnxGraphYolo, "temporal": OnnxGraphTemporal,
           "classifier": OnnxGraphClassifier}[kind]
    try:
        model = cls(graph, **kwargs)
        hw = kwargs["input_hw"]
        shape = (1, kwargs["t_len"], *hw, 3) if kind == "temporal" else (1, *hw, 3)
        model.apply(model.meta_params(), torch.empty(shape, device="meta"))
        return model
    except UnsupportedOnnxOp as exc:
        logger.warning("'%s' has a full ONNX graph but it is not servable: %s — "
                       "falling back", path, exc)
        return None
    except Exception:  # noqa: BLE001
        logger.exception("'%s': ONNX graph compilation failed — falling back", path)
        return None


def load_graph_fallback(path: str, kind: str, **kwargs) -> Optional[OnnxGraphModel]:
    """The engines' last-resort loader: when no named checkpoint layout
    matched, serve the file's own graph. Returns the adapter (its params are
    its buffers) or None (the engines then fall through to their random-init
    warning). The log line is the documented serve-path marker — keep it
    stable."""
    gm = try_load_graph_model(path, kind, **kwargs)
    if gm is None:
        return None
    logger.info(
        "'%s' matches no known checkpoint layout — serving its ONNX graph directly "
        "(generic ONNX->torch path)", path)
    return gm
