"""Native YOLO -> standard ONNX graph export.

Emits the Ultralytics-compatible serving graph for a native
``models.yolo.YoloModel`` + params pytree: input ``images``
[N, 3, H, W] (RGB, /255), output ``output0`` [N, 4+nc, A] — decoded
xywh center boxes in input pixels concatenated with per-class sigmoid
scores, exactly the matrix the reference's ONNX backend consumes
(reference detector.py:484-609) and that this framework's own graph
path serves (models/onnx_graph_model.OnnxGraphYolo).

Why it exists:
* round-trip fidelity gate — the exported file re-served through the
  generic ONNX graph path must reproduce the native engine's
  detections (tests/test_torch_onnx_serving.py);
* the quantization toolchain (scripts/quantize_model.py) operates on
  ONNX files, so this is how the NATIVE flagship model reaches the
  measured QDQ-int8-weights + bf16 serving mode (round-4 VERDICT #4);
* interop: the file is a standard opset-17 model any runtime can load.

The graph is emitted in plain NCHW with no TPU-ism: Conv+Sigmoid+Mul
blocks, Split/Concat for C2f, MaxPool chains for SPPF, Resize for the
upsample, and the v8 DFL decode as Reshape/Softmax/Mul/ReduceSum with
anchor/stride constants — the layout every public YOLO export uses, so
foreign consumers (and the in-repo twin executors) treat it exactly
like an Ultralytics file.

The port's counterpart of ``realtime_analytics_tpu/models/onnx_export.py``,
over the port's ``YoloModel`` and a params tree of numpy arrays
(``weights.params_to_tree``, or a JAX-layout tree): given the same tree it
writes the same bytes as the JAX package's exporter.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .onnx_lite import OnnxGraph, OnnxNode, write_onnx_model
from .yolo import REG_MAX, STRIDES, V5_ANCHORS, YoloModel


class _Builder:
    def __init__(self):
        self.nodes: List[OnnxNode] = []
        self.inits: Dict[str, np.ndarray] = {}
        self._n = 0

    def name(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def init(self, hint: str, arr: np.ndarray) -> str:
        name = self.name(hint)
        self.inits[name] = np.asarray(arr)
        return name

    def node(self, op: str, inputs: Sequence[str], n_out: int = 1,
             **attrs) -> List[str]:
        outs = [self.name(op.lower()) for _ in range(n_out)]
        self.nodes.append(OnnxNode(op_type=op, inputs=list(inputs),
                                   outputs=outs, name=outs[0], attrs=attrs))
        return outs

    def op(self, op: str, *inputs: str, **attrs) -> str:
        return self.node(op, inputs, **attrs)[0]


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def get_weight(p: Dict) -> np.ndarray:
    """A conv node's HWIO weight; an int8 node ``{"w_q", "w_scale"}`` is
    dequantised as the JAX package's ``layers.get_weight`` does: both
    operands rounded to bf16, their product rounded to bf16."""
    if "w_q" in p:
        import torch

        w = (torch.as_tensor(np.asarray(p["w_q"])).to(torch.bfloat16)
             * torch.as_tensor(np.asarray(p["w_scale"])).to(torch.bfloat16))
        return w.float().numpy()
    return np.asarray(p["w"])


def _conv(b: _Builder, p: Dict, x: str, k: int, stride: int = 1,
          pad: int = None, act: bool = True) -> str:
    """conv_act as ONNX: Conv (+bias) then SiLU = Sigmoid*x."""
    w = _np(get_weight(p))  # [kh, kw, ci, co] HWIO
    w_onnx = w.transpose(3, 2, 0, 1)  # OIHW
    pad = k // 2 if pad is None else pad
    inputs = [x, b.init("w", w_onnx)]
    bias = p.get("b")
    if bias is not None:
        inputs.append(b.init("bias", _np(bias)))
    y = b.op("Conv", *inputs, strides=[stride, stride],
             pads=[pad, pad, pad, pad], kernel_shape=[k, k], group=1)
    if act:
        s = b.op("Sigmoid", y)
        y = b.op("Mul", y, s)
    return y


def _bottleneck(b: _Builder, p: Dict, x: str, shortcut: bool,
                k1: int, k2: int, cin_eq: bool) -> str:
    y = _conv(b, p["cv1"], x, k1)
    y = _conv(b, p["cv2"], y, k2)
    return b.op("Add", x, y) if shortcut and cin_eq else y


def _c2f(b: _Builder, p: Dict, x: str, n: int, shortcut: bool) -> str:
    y = _conv(b, p["cv1"], x, 1)
    c2 = _np(get_weight(p["cv1"])).shape[-1]  # int8 params carry w_q, not w
    a, cur = b.node("Split", [y, b.init("split", np.asarray(
        [c2 // 2, c2 // 2], np.int64))], n_out=2, axis=1)
    ys = [a, cur]
    for j in range(n):
        cur = _bottleneck(b, p["m"][j], cur, shortcut, 3, 3, True)
        ys.append(cur)
    cat = b.op("Concat", *ys, axis=1)
    return _conv(b, p["cv2"], cat, 1)


def _c3(b: _Builder, p: Dict, x: str, n: int, shortcut: bool) -> str:
    a = _conv(b, p["cv1"], x, 1)
    c = _conv(b, p["cv2"], x, 1)
    for j in range(n):
        a = _bottleneck(b, p["m"][j], a, shortcut, 1, 3, True)
    cat = b.op("Concat", a, c, axis=1)
    return _conv(b, p["cv3"], cat, 1)


def _sppf(b: _Builder, p: Dict, x: str, k: int) -> str:
    y = _conv(b, p["cv1"], x, 1)
    pads = [k // 2] * 4
    p1 = b.op("MaxPool", y, kernel_shape=[k, k], strides=[1, 1], pads=pads)
    p2 = b.op("MaxPool", p1, kernel_shape=[k, k], strides=[1, 1], pads=pads)
    p3 = b.op("MaxPool", p2, kernel_shape=[k, k], strides=[1, 1], pads=pads)
    cat = b.op("Concat", y, p1, p2, p3, axis=1)
    return _conv(b, p["cv2"], cat, 1)


def _upsample2x(b: _Builder, x: str) -> str:
    scales = b.init("scales", np.asarray([1.0, 1.0, 2.0, 2.0], np.float32))
    return b.op("Resize", x, "", scales, mode="nearest",
                coordinate_transformation_mode="asymmetric",
                nearest_mode="floor")


def _anchors_xy(h: int, w: int) -> np.ndarray:
    """[1, 2, h*w] grid centers (x row, y row), +0.5 like _detect_v8."""
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32) + 0.5
    return np.stack([gx.reshape(-1), gy.reshape(-1)])[None]


def _detect_v8(b: _Builder, p: Dict, feats: Sequence[str],
               hw: Sequence[tuple], nc: int) -> str:
    proj = np.arange(REG_MAX, dtype=np.float32).reshape(1, 1, REG_MAX, 1)
    proj_name = b.init("dfl_proj", proj)
    half = b.init("half", np.asarray(0.5, np.float32))
    lvls = []
    for lvl, x in enumerate(feats):
        h, w = hw[lvl]
        stride = float(STRIDES[lvl])
        box = x
        for j, blk in enumerate(p["cv2"][lvl]):
            box = _conv(b, blk, box, 3 if j < 2 else 1, act=j < 2)
        cls = x
        for j, blk in enumerate(p["cv3"][lvl]):
            cls = _conv(b, blk, cls, 3 if j < 2 else 1, act=j < 2)
        # DFL: [N, 64, h, w] -> [N, 4, 16, hw] -> softmax(bins) -> E[bin]
        shp = b.init("shape", np.asarray([0, 4, REG_MAX, h * w], np.int64))
        d = b.op("Reshape", box, shp)
        d = b.op("Softmax", d, axis=2)
        d = b.op("Mul", d, proj_name)
        dist = b.op("ReduceSum", d, b.init("axes", np.asarray([2], np.int64)),
                    keepdims=0)  # [N, 4, hw] (l, t, r, b)
        axes1 = b.init("axes", np.asarray([1], np.int64))
        lt = b.op("Slice", dist, b.init("st", np.asarray([0], np.int64)),
                  b.init("en", np.asarray([2], np.int64)), axes1)
        rb = b.op("Slice", dist, b.init("st", np.asarray([2], np.int64)),
                  b.init("en", np.asarray([4], np.int64)), axes1)
        anc = b.init("anchors", _anchors_xy(h, w))
        x1y1 = b.op("Sub", anc, lt)
        x2y2 = b.op("Add", anc, rb)
        cxy = b.op("Mul", b.op("Add", x1y1, x2y2), half)
        wh = b.op("Sub", x2y2, x1y1)
        boxes = b.op("Concat", cxy, wh, axis=1)  # [N, 4, hw] xywh, grid units
        boxes = b.op("Mul", boxes,
                     b.init("stride", np.asarray(stride, np.float32)))
        cshp = b.init("shape", np.asarray([0, nc, h * w], np.int64))
        scores = b.op("Sigmoid", b.op("Reshape", cls, cshp))
        lvls.append(b.op("Concat", boxes, scores, axis=1))  # [N, 4+nc, hw]
    return b.op("Concat", *lvls, axis=2)  # [N, 4+nc, A]


def _detect_v5(b: _Builder, p: Dict, feats: Sequence[str],
               hw: Sequence[tuple], nc: int) -> str:
    """v5 head -> the reference's [N, A, 5+nc] matrix: sigmoid everywhere,
    xywh decoded with the v5 grid/anchor rules (models/yolo._detect_v5)."""
    anchor_table = p.get("anchors")
    anchor_table = (np.asarray(V5_ANCHORS, np.float32)
                    if anchor_table is None else _np(anchor_table))
    na = anchor_table.shape[1]
    half = b.init("half", np.asarray(0.5, np.float32))
    two = b.init("two", np.asarray(2.0, np.float32))
    lvls = []
    for lvl, x in enumerate(feats):
        h, w = hw[lvl]
        stride = float(STRIDES[lvl])
        raw = _conv(b, p["m"][lvl], x, 1, act=False)  # [N, na*(5+nc), h, w]
        shp = b.init("shape",
                     np.asarray([0, na, 5 + nc, h * w], np.int64))
        raw = b.op("Reshape", raw, shp)
        y = b.op("Sigmoid", raw)  # [N, na, 5+nc, hw]
        axes2 = b.init("axes", np.asarray([2], np.int64))

        def sl(v, s, e):
            return b.op("Slice", v, b.init("st", np.asarray([s], np.int64)),
                        b.init("en", np.asarray([e], np.int64)), axes2)

        # grid constants [1, 1, 2, hw]; per-level anchors [1, na, 2, 1]
        grid = _anchors_xy(h, w) - 0.5  # v5 adds no half-cell
        grid = grid[:, None]
        anc = anchor_table[lvl].reshape(1, na, 2, 1)
        xy = sl(y, 0, 2)
        xy = b.op("Mul", xy, two)
        xy = b.op("Sub", xy, half)
        xy = b.op("Add", xy, b.init("grid", grid))
        xy = b.op("Mul", xy, b.init("stride", np.asarray(stride, np.float32)))
        wh = b.op("Mul", sl(y, 2, 4), two)
        wh = b.op("Mul", wh, wh)
        wh = b.op("Mul", wh, b.init("anchors", anc))
        obj_cls = sl(y, 4, 5 + nc)
        lvl_out = b.op("Concat", xy, wh, obj_cls, axis=2)  # [N, na, 5+nc, hw]
        # anchor-MINOR row order (h, w, na) — matches models/yolo._detect_v5
        # reshaping its NHWC [n, h, w, na, 5+nc] tensor
        t = b.op("Transpose", lvl_out, perm=[0, 3, 1, 2])  # [N, hw, na, 5+nc]
        oshp = b.init("shape",
                      np.asarray([0, na * h * w, 5 + nc], np.int64))
        lvls.append(b.op("Reshape", t, oshp))
    return b.op("Concat", *lvls, axis=1)  # [N, A, 5+nc]


def yolo_to_onnx(model: YoloModel, params: Dict, path: str,
                 input_hw: Sequence[int] = (640, 640)) -> None:
    """Serialize the native model + params as a standard ONNX file.

    Walks ``model.nodes`` with the same dataflow as ``YoloModel.apply``
    (no neck fusion, no s2d — plain semantics every runtime understands)
    and the exact decode of models/yolo._detect_v8/_detect_v5."""
    ih, iw = int(input_hw[0]), int(input_hw[1])
    b = _Builder()
    layers = params["layers"]
    vals: List[str] = [None] * len(model.nodes)
    shapes: List[tuple] = [None] * len(model.nodes)  # (h, w) per node
    prev, prev_hw = "images", (ih, iw)
    out_name = None
    for i, node in enumerate(model.nodes):
        srcs = [s if s >= 0 else i - 1 for s in node.src]
        ins = [prev if s == i - 1 and i > 0 else vals[s] for s in srcs]
        in_hw = [prev_hw if s == i - 1 and i > 0 else shapes[s] for s in srcs]
        if i == 0:
            ins, in_hw = ["images"], [(ih, iw)]
        p = layers.get(str(i), {})
        h, w = in_hw[0]
        if node.kind == "conv":
            y = _conv(b, p, ins[0], node.k, stride=node.s, pad=node.p)
            hw = (h // node.s, w // node.s)
        elif node.kind == "c2f":
            y = _c2f(b, p, ins[0], node.n, node.shortcut)
            hw = (h, w)
        elif node.kind == "c3":
            y = _c3(b, p, ins[0], node.n, node.shortcut)
            hw = (h, w)
        elif node.kind == "sppf":
            y = _sppf(b, p, ins[0], node.k)
            hw = (h, w)
        elif node.kind == "upsample":
            y = _upsample2x(b, ins[0])
            hw = (h * 2, w * 2)
        elif node.kind == "concat":
            y = b.op("Concat", *ins, axis=1)
            hw = in_hw[0]
        elif node.kind == "detect_v8":
            out_name = _detect_v8(b, p, ins, in_hw, model.nc)
            break
        elif node.kind == "detect_v5":
            out_name = _detect_v5(b, p, ins, in_hw, model.nc)
            break
        else:  # pragma: no cover
            raise ValueError(f"unknown node kind {node.kind}")
        vals[i], shapes[i] = y, hw
        prev, prev_hw = y, hw
    if out_name is None:  # pragma: no cover
        raise ValueError("model graph has no detect head")
    # canonical ultralytics output name
    b.nodes[-1].outputs[0] = "output0"
    graph = OnnxGraph(nodes=b.nodes, initializers=b.inits,
                      inputs=["images"], outputs=["output0"])
    a_total = sum((ih // s) * (iw // s) for s in STRIDES)
    if model.version == 8:
        out_shape = ("N", 4 + model.nc, a_total)
    else:
        na = len(V5_ANCHORS[0])
        out_shape = ("N", a_total * na, 5 + model.nc)
    write_onnx_model(
        path, graph,
        value_infos={
            "images": (np.float32, ("N", 3, ih, iw)),
            "output0": (np.float32, out_shape),
        },
        graph_name=f"yolov{model.version}{model.size}",
    )
