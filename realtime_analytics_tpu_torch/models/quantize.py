"""Post-training static quantization: fp32 ONNX graph -> quantized ONNX.

The reference's RKNN backend consumes *pre-quantized* artifacts produced
by an external toolchain (the RKNN toolkit's calibration flow; reference
detector.py:705-869 serves the result uint8-in, NPU-side int8 math). The
ONNX ecosystem's equivalent producer is onnxruntime's static quantizer.
This module is the in-repo analog: calibrate a float graph on sample
inputs, then emit either interchange format both of this package's
executors (``onnx_exec`` numpy oracle, ``onnx_torch`` planned path) already
serve:

* **QDQ** (default): per-output-channel int8 weights behind
  ``DequantizeLinear`` (they stay 1 byte/element in device memory via the
  ``serving_params`` int8 barrier), ``QuantizeLinear``/``DequantizeLinear``
  pairs around each quantized activation; compute stays float. This is
  the artifact shape torch's fake-quant exporter and onnxruntime's QDQ
  quantizer produce.
* **QOperator**: ``Conv``(+``Relu``) collapses into ``QLinearConv`` and
  ``MatMul`` into ``QLinearMatMul`` — integer compute end to end between
  the Q/DQ boundary pairs; on the card these run as exact s8 x s8 -> s32
  products (``ops/int8.py::int8_matmul``, ``torch._int_mm``). The Conv+Relu
  fusion is exact: with a post-ReLU calibration range the output zero
  point is the quantized 0, so uint8 saturation IS the ReLU.

Calibration: per-tensor asymmetric uint8 for activations (range always
includes 0, so zero is exactly representable — the ONNX
DynamicQuantizeLinear convention); per-output-channel symmetric int8 for
Conv/ConvTranspose weights, per-tensor symmetric int8 for MatMul/Gemm
weights; int32 bias at scale ``x_scale * w_scale`` (QOperator only).

The port's copy of ``realtime_analytics_tpu/models/quantize.py`` (numpy
only), reading the port's own ``onnx_exec`` and ``onnx_lite``: the PyTorch
package imports nothing of the JAX package.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .onnx_exec import run_graph
from .onnx_lite import OnnxGraph, OnnxNode

logger = logging.getLogger(__name__)

# ops whose weight operand (input index 1) is quantized; value = the
# per-channel axis for the weight tensor, or None for per-tensor
# (Gemm is resolved per node: transB=1 weights are [N, K] with output
# channels leading -> axis 0; transB=0 stays per-tensor)
_WEIGHT_AXIS = {
    "Conv": 0,           # [M, C/g, *k] — out channels lead
    "ConvTranspose": 1,  # [C, M/g, *k] — out channels at dim 1
    "MatMul": None,
    "Gemm": None,
}


def _axis_for(node: OnnxNode) -> Optional[int]:
    """Per-channel axis for a target node's weight, or None (per-tensor)."""
    if node.op_type == "Gemm":
        return 0 if int(node.attrs.get("transB", 0)) else None
    return _WEIGHT_AXIS[node.op_type]


@dataclass
class _Range:
    lo: float = 0.0  # quantization range always includes 0
    hi: float = 0.0

    def update(self, arr: np.ndarray) -> None:
        if arr.size:
            self.lo = min(self.lo, float(arr.min()))
            self.hi = max(self.hi, float(arr.max()))

    def scale_zp(self) -> Tuple[np.float32, np.uint8]:
        scale = (self.hi - self.lo) / 255.0
        if scale <= 0.0:
            return np.float32(1.0), np.uint8(0)
        zp = int(np.clip(np.rint(-self.lo / scale), 0, 255))
        return np.float32(scale), np.uint8(zp)


@dataclass
class QuantizationReport:
    """What the pass did — returned next to the graph for CLI reporting
    and test assertions."""

    weights_quantized: List[str] = field(default_factory=list)
    activations_quantized: List[str] = field(default_factory=list)
    qlinear_nodes: int = 0
    fused_relus: int = 0
    calibration_samples: int = 0
    # calibrated activation ranges {tensor: (lo, hi)} — pass back in as
    # quantize_graph(reuse_ranges=...) to quantize the same graph in
    # another format without re-running calibration
    ranges: Dict[str, Tuple[float, float]] = field(default_factory=dict)

    def summary(self) -> str:
        return (
            f"{len(self.weights_quantized)} weight tensor(s) -> int8, "
            f"{len(self.activations_quantized)} activation(s) -> uint8, "
            f"{self.qlinear_nodes} QLinear op(s), "
            f"{self.fused_relus} Conv+Relu fusion(s), "
            f"{self.calibration_samples} calibration sample(s)"
        )


def _target_nodes(g: OnnxGraph, exclude: Sequence[str]) -> List[OnnxNode]:
    out = []
    for node in g.nodes:
        if node.op_type not in _WEIGHT_AXIS or node.name in exclude:
            continue
        if len(node.inputs) < 2 or node.inputs[1] not in g.initializers:
            continue  # dynamic weights stay float
        w = np.asarray(g.initializers[node.inputs[1]])
        if not np.issubdtype(w.dtype, np.floating):
            continue  # already quantized
        out.append(node)
    return out


def _calibrate(
    g: OnnxGraph,
    calib_feeds: Iterable[Dict[str, np.ndarray]],
    act_names: Sequence[str],
) -> Tuple[Dict[str, _Range], int]:
    ranges = {t: _Range() for t in act_names}
    n = 0
    for feeds in calib_feeds:
        vals = run_graph(g, feeds, outputs=list(act_names))
        for t, v in zip(act_names, vals):
            ranges[t].update(np.asarray(v, dtype=np.float32))
        n += 1
    if n == 0:
        raise ValueError("calibration produced no samples")
    return ranges, n


def _quantize_weight(
    w: np.ndarray, axis: Optional[int]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetric int8: per-channel along ``axis`` (scale shape [C]) or
    per-tensor (scalar scale) when ``axis`` is None."""
    w = np.asarray(w, dtype=np.float32)
    if axis is None:
        absmax = np.float32(np.abs(w).max()) if w.size else np.float32(0)
        scale = np.float32(max(absmax / 127.0, 1e-12))
        zp = np.int8(0)
    else:
        red = tuple(i for i in range(w.ndim) if i != axis)
        absmax = np.abs(w).max(axis=red) if w.size else np.zeros(
            w.shape[axis], np.float32)
        scale = np.maximum(absmax / 127.0, 1e-12).astype(np.float32)
        zp = np.zeros(w.shape[axis], dtype=np.int8)
    shape = [1] * w.ndim
    if axis is not None:
        shape[axis] = -1
    s = scale.reshape(shape) if axis is not None else scale
    wq = np.clip(np.rint(w / s), -128, 127).astype(np.int8)
    return wq, scale, zp


def quantize_graph(
    g: OnnxGraph,
    calib_feeds: Iterable[Dict[str, np.ndarray]],
    fmt: str = "qdq",
    exclude: Sequence[str] = (),
    reuse_ranges: Optional[Dict[str, Tuple[float, float]]] = None,
    weights_only: bool = False,
) -> Tuple[OnnxGraph, QuantizationReport]:
    """Quantize ``g`` (fp32, single data input) into a new OnnxGraph in
    ``fmt`` ('qdq' or 'qoperator'). ``calib_feeds`` yields
    {input name: array} calibration feeds; ``exclude`` names nodes to
    leave float; ``reuse_ranges`` (a prior report's ``.ranges``) skips
    calibration when it covers every needed tensor. ``weights_only``
    (QDQ only) quantizes just the weight initializers — no calibration,
    no activation Q/DQ — for lossless-er compression when activation
    quantization noise is unwanted. The input graph is not mutated."""
    if fmt not in ("qdq", "qoperator"):
        raise ValueError(f"unknown quantization format {fmt!r}")
    if weights_only and fmt != "qdq":
        raise ValueError("weights_only requires fmt='qdq' (QOperator "
                         "needs quantized activations)")
    report = QuantizationReport()
    targets = _target_nodes(g, exclude)
    if not targets:
        raise ValueError(
            "nothing to quantize: no Conv/ConvTranspose/MatMul/Gemm nodes "
            "with float initializer weights"
        )
    graph_outputs = set(g.outputs)

    # -- choose activation tensors: each target's data input + output;
    # graph outputs stay float (heads keep fp32, the torch-export shape)
    act_names: List[str] = []
    if not weights_only:
        for node in targets:
            for t in (node.inputs[0], node.outputs[0]):
                if (
                    t
                    and t not in g.initializers
                    and t not in graph_outputs
                    and t not in act_names
                ):
                    act_names.append(t)
    if not act_names:
        ranges: Dict[str, _Range] = {}
    elif reuse_ranges is not None and all(t in reuse_ranges
                                          for t in act_names):
        ranges = {t: _Range(*reuse_ranges[t]) for t in act_names}
    else:
        ranges, report.calibration_samples = _calibrate(
            g, calib_feeds, act_names)
    report.ranges = {t: (r.lo, r.hi) for t, r in ranges.items()}

    producers: Dict[str, OnnxNode] = {}
    consumers: Dict[str, List[OnnxNode]] = {}
    for node in g.nodes:
        for o in node.outputs:
            if o:
                producers[o] = node
        for i in node.inputs:
            if i:
                consumers.setdefault(i, []).append(node)

    # -- QOperator planning: Conv(+sole-consumer Relu) -> QLinearConv,
    # MatMul -> QLinearMatMul. Output tensor of the fused group must be a
    # calibrated activation (not a graph output).
    target_set = {id(n) for n in targets}
    qlinear: Dict[int, Tuple[str, Optional[OnnxNode]]] = {}
    dead_nodes: set = set()
    if fmt == "qoperator":
        for node in targets:
            y = node.outputs[0]
            relu: Optional[OnnxNode] = None
            if node.op_type == "Conv":
                cons = consumers.get(y, [])
                if (
                    len(cons) == 1
                    and cons[0].op_type == "Relu"
                    and y not in graph_outputs
                    and cons[0].outputs[0] not in graph_outputs
                    and cons[0].outputs[0] in ranges
                ):
                    relu = cons[0]
                    y = relu.outputs[0]
            if y not in ranges or node.inputs[0] not in ranges:
                continue  # boundary node: stays float in QDQ form
            if node.op_type in ("Conv", "MatMul"):
                qlinear[id(node)] = (y, relu)
                if relu is not None:
                    dead_nodes.add(id(relu))
                    report.fused_relus += 1

    inits: Dict[str, np.ndarray] = dict(g.initializers)
    new_nodes: List[OnnxNode] = []
    taken = set(inits) | set(producers) | set(g.inputs)

    def _uniq(name: str) -> str:
        base, n = name, 1
        while name in taken:
            name = f"{base}.{n}"
            n += 1
        taken.add(name)
        return name

    # -- activation Q/DQ insertion map: tensor -> (q_name, dq_name)
    act_tensors: Dict[str, Tuple[str, str]] = {}
    act_params: Dict[str, Tuple[str, str]] = {}  # tensor -> (scale, zp)
    for t in act_names:
        s_name, z_name = _uniq(f"{t}_scale"), _uniq(f"{t}_zero_point")
        scale, zp = ranges[t].scale_zp()
        inits[s_name] = np.float32(scale).reshape(())
        inits[z_name] = np.uint8(zp).reshape(())
        act_params[t] = (s_name, z_name)
        act_tensors[t] = (_uniq(f"{t}_quantized"), _uniq(f"{t}_dq"))

    def _emit_q_dq(t: str) -> None:
        q, dq = act_tensors[t]
        s, z = act_params[t]
        new_nodes.append(OnnxNode(
            op_type="QuantizeLinear", inputs=[t, s, z], outputs=[q],
            name=_uniq(f"Quantize_{t}")))
        new_nodes.append(OnnxNode(
            op_type="DequantizeLinear", inputs=[q, s, z], outputs=[dq],
            name=_uniq(f"Dequantize_{t}")))

    # -- weight quantization (shared by both formats). Keyed by
    # (weight name, per-channel axis): a weight shared by targets of
    # different op types quantizes once per axis semantics, never with
    # the first consumer's axis applied to the second. Stale float
    # copies (incl. one still consumed as another node's data input)
    # are handled by the final reachability prune, never deleted early.
    WKey = Tuple[str, Optional[int]]
    weight_dq: Dict[WKey, str] = {}      # -> DQ output name
    weight_q: Dict[WKey, Tuple[str, str, str]] = {}  # -> (q, scale, zp)
    for node in targets:
        w_name = node.inputs[1]
        axis = _axis_for(node)
        key = (w_name, axis)
        if key in weight_dq:
            continue
        wq, scale, zp = _quantize_weight(np.asarray(inits[w_name]), axis)
        qn, sn, zn = (_uniq(f"{w_name}_quantized"),
                      _uniq(f"{w_name}_scale"), _uniq(f"{w_name}_zero_point"))
        dqn = _uniq(f"{w_name}_dq")
        inits[qn], inits[sn], inits[zn] = wq, scale, zp
        weight_q[key] = (qn, sn, zn)
        weight_dq[key] = dqn
        if w_name not in report.weights_quantized:
            report.weights_quantized.append(w_name)

    def _weight_dq_node(node: OnnxNode) -> None:
        key = (node.inputs[1], _axis_for(node))
        qn, sn, zn = weight_q[key]
        axis = key[1]
        attrs = {} if axis is None else {"axis": axis}
        new_nodes.append(OnnxNode(
            op_type="DequantizeLinear", inputs=[qn, sn, zn],
            outputs=[weight_dq[key]], attrs=attrs,
            name=_uniq(f"Dequantize_{node.inputs[1]}")))

    emitted_weight_dq: set = set()
    emitted_act: set = set()

    def _ensure_act(t: str) -> None:
        if t in act_tensors and t not in emitted_act:
            _emit_q_dq(t)
            emitted_act.add(t)

    # graph inputs that are quantized activations get their Q/DQ first
    for t in g.inputs:
        _ensure_act(t)

    for node in g.nodes:
        if id(node) in dead_nodes:
            continue
        if id(node) in qlinear:
            y_tensor, relu = qlinear[id(node)]
            x_t = node.inputs[0]
            xq, _ = act_tensors[x_t]
            xs, xz = act_params[x_t]
            w_name = node.inputs[1]
            wq, ws, wz = weight_q[(w_name, _axis_for(node))]
            ys, yz = act_params[y_tensor]
            yq, _ = act_tensors[y_tensor]
            if node.op_type == "Conv":
                qins = [xq, xs, xz, wq, ws, wz, ys, yz]
                if len(node.inputs) > 2 and node.inputs[2]:
                    b = np.asarray(inits[node.inputs[2]], dtype=np.float64)
                    x_scale = float(np.asarray(inits[xs]).reshape(()))
                    w_scale = np.asarray(inits[ws], dtype=np.float64)
                    bq = np.clip(
                        np.rint(b / (x_scale * w_scale)),
                        np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                    ).astype(np.int32)
                    bq_name = _uniq(f"{node.inputs[2]}_quantized")
                    inits[bq_name] = bq
                    qins.append(bq_name)
                new_nodes.append(OnnxNode(
                    op_type="QLinearConv", inputs=qins, outputs=[yq],
                    attrs=dict(node.attrs),
                    name=node.name or _uniq("QLinearConv")))
            else:  # MatMul
                new_nodes.append(OnnxNode(
                    op_type="QLinearMatMul",
                    inputs=[xq, xs, xz, wq, ws, wz, ys, yz], outputs=[yq],
                    name=node.name or _uniq("QLinearMatMul")))
            report.qlinear_nodes += 1
            # DQ for float consumers of the group output
            s, z = act_params[y_tensor]
            _, dq = act_tensors[y_tensor]
            new_nodes.append(OnnxNode(
                op_type="DequantizeLinear", inputs=[yq, s, z], outputs=[dq],
                name=_uniq(f"Dequantize_{y_tensor}")))
            emitted_act.add(y_tensor)
            continue

        # regular node: rewire quantized-activation inputs to their DQ,
        # quantized weights to their weight-DQ
        new_inputs = list(node.inputs)
        if id(node) in target_set:
            w_name = node.inputs[1]
            wkey = (w_name, _axis_for(node))
            if wkey not in emitted_weight_dq:
                _weight_dq_node(node)
                emitted_weight_dq.add(wkey)
            new_inputs[1] = weight_dq[wkey]
        for i, t in enumerate(new_inputs):
            if i == 1 and id(node) in target_set:
                continue
            if t in act_tensors:
                new_inputs[i] = act_tensors[t][1]
        new_nodes.append(OnnxNode(
            op_type=node.op_type, inputs=new_inputs,
            outputs=list(node.outputs), name=node.name,
            attrs=dict(node.attrs)))
        for o in node.outputs:
            _ensure_act(o)

    # dead-node elimination: QOperator conversion leaves Q/DQ heads with
    # no consumer (e.g. the DQ twin of a tensor only consumed quantized);
    # drop any node unreachable from the graph outputs, then any
    # initializer no longer referenced (replaced fp32 weights)
    live = set(g.outputs)
    kept_rev: List[OnnxNode] = []
    for node in reversed(new_nodes):
        if any(o in live for o in node.outputs):
            kept_rev.append(node)
            live.update(i for i in node.inputs if i)
    new_nodes = list(reversed(kept_rev))
    used = set(g.outputs)
    for node in new_nodes:
        used.update(node.inputs)
    new_inits = {k: v for k, v in inits.items() if k in used}

    # report only activations whose scale survived the prune (a fused
    # group's pre-ReLU tensor is calibrated but never materialized)
    report.activations_quantized = [
        t for t in act_names if act_params[t][0] in new_inits
    ]

    out = OnnxGraph(
        nodes=new_nodes,
        initializers=new_inits,
        inputs=list(g.inputs),
        outputs=list(g.outputs),
    )
    logger.info("quantized graph: %s", report.summary())
    return out, report
