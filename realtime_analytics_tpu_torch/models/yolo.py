"""YOLOv8 (anchor-free, DFL) and YOLOv5 (anchor-based) as PyTorch modules.

Counterpart of ``realtime_analytics_tpu/models/yolo.py``: the same
declarative node graph (indices match the published Ultralytics YAML
layouts), the same block structure and parameter names, so a JAX params
tree maps onto this module key by key (``weights.params_from_jax``).

Layout: ``forward`` takes the JAX package's NHWC input and views it as an
NCHW tensor in ``channels_last`` memory (no copy); every conv then runs
channels_last. Outputs are decoded exactly as the reference's
``YoloModel.apply``: boxes in input-pixel xyxy plus either per-class
scores or, with ``reduce_scores=True``, the per-anchor (conf, cls) pair.

Decode semantics (the JAX package's):
  * v8: DFL expectation over 16 bins -> ltrb cell distances -> xyxy * stride;
    scores = sigmoid(cls logits);
  * v5: sigmoid everything; xy = (2p - 0.5 + grid) * stride, wh = (2p)^2 *
    anchor; scores = objectness * class probs, and with ``reduce_scores``
    conf = sigmoid(obj) * sigmoid(max raw cls). The anchors live in the
    params tree (a checkpoint's own override the defaults) and take the
    engine's compute dtype with every other float, as in the JAX package.

Kernels on this path: the fused stem B3 (nodes 0 + 1, ``pallas_stem``) and
the v8 head decode B2 (``pallas_decode``). ``"off"`` runs the plain
layer-by-layer path. B3 needs the v8 k3-s2 stem and float weights: it is
off for v5 (a k6 stem) and for int8 weights, as in the JAX package.

Neck fusion (``fuse_neck``, on by default as in the JAX package): at each
upsample -> two-input concat -> C2f/C3 junction whose upsample and concat
feed only the next node (``_neck_fusions``: 4 entries on v8 and on v5),
the upsample and the concat pass their inputs lazily to the block, whose
leading 1x1 conv(s) take them through ``ConvAct.up_concat``: the 2x
upsampled tensor and the concat are never written. Off for int8 weights
(their activation scales were calibrated on the unsplit input).
``prepare_neck`` keeps the split weight halves of a serving model; these
are plain cuDNN convs, which the JAX package computes in XLA.

s2d (``forward(..., s2d=True)``, the engine's ``s2d_backbone: on``):
nodes 0-3 run over space-to-depth tensors (``models/s2d.py``) where the
prefix applies (float weights, H and W multiples of 4), taking precedence
over B3 as in the JAX package; ``prepare_s2d`` scatters the weights once.

int8: every ``ConvAct`` that holds int8 weights runs the full int8 conv
(``ops/int8.py``), as the JAX package's ``act_int8``; the v5 head conv
stays weight-only (dequantised in bf16), as the JAX package's
``_detect_v5``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.decode import REG_MAX, decode_v8_levels, decode_v8_levels_plain
from ..ops.stem import (
    StemWeights,
    fused_stem_p1p2,
    prepare_stem,
    stem_geometry_ok,
)
from .layers import ConvAct, conv2d, make_divisible, max_pool, upsample2x
from .s2d import (
    S2DWeight,
    c2f_s2d,
    c3_s2d,
    plain_scatter,
    prefix_convs,
    s2d_conv,
    s2d_conv_weight,
    space_to_depth,
)

# ---------------------------------------------------------------------------
# Graph spec (identical to the reference)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Node:
    kind: str  # conv | c2f | c3 | sppf | upsample | concat | detect_v8 | detect_v5
    src: Tuple[int, ...]  # input node indices; -1 = previous node
    c2: int = 0  # output channels
    k: int = 1
    s: int = 1
    p: Optional[int] = None
    n: int = 1  # block repeats
    shortcut: bool = True


V8_SCALES = {  # depth, width, max_channels
    "n": (0.33, 0.25, 1024),
    "s": (0.33, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}

V5_SCALES = {  # depth, width
    "n": (0.33, 0.25),
    "s": (0.33, 0.50),
    "m": (0.67, 0.75),
    "l": (1.00, 1.00),
    "x": (1.33, 1.25),
}

V5_ANCHORS = (  # per level (P3, P4, P5), (w, h) pairs at input scale
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)

STRIDES = (8, 16, 32)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int, k1: int = 3, k2: int = 3):
        super().__init__()
        self.cv1 = ConvAct(c1, c2, k1)
        self.cv2 = ConvAct(c2, c2, k2)
        self.c2 = c2

    def forward(self, x: torch.Tensor, shortcut: bool) -> torch.Tensor:
        """``x + cv2(cv1(x))`` with the shortcut, the add done by ``cv2``
        (on the card inside its epilogue); ``cv2(cv1(x))`` without."""
        y = self.cv1(x)
        if shortcut and x.shape[1] == self.c2:
            return self.cv2(y, residual=x)
        return self.cv2(y)


class C2f(nn.Module):
    def __init__(self, c1: int, c2: int, n: int, shortcut: bool):
        super().__init__()
        c = int(c2 * 0.5)
        self.cv1 = ConvAct(c1, 2 * c, 1)
        self.cv2 = ConvAct((2 + n) * c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(c, c) for _ in range(n))
        self.shortcut = shortcut

    def forward(self, x) -> torch.Tensor:
        """``x``: a tensor, or the fused neck's ("lazy_up_concat", x_small,
        y_skip)."""
        y = self.cv1.up_concat(x[1], x[2]) if isinstance(x, tuple) else self.cv1(x)
        a, b = y.chunk(2, dim=1)
        ys = [a, b]
        cur = b
        for blk in self.m:
            cur = blk(cur, self.shortcut)
            ys.append(cur)
        return self.cv2(torch.cat(ys, dim=1))


class C3(nn.Module):
    """YOLOv5 CSP block: two 1x1 branches, bottlenecks (1x1 then 3x3) on
    the first, a 1x1 over their concat."""

    def __init__(self, c1: int, c2: int, n: int, shortcut: bool):
        super().__init__()
        c = int(c2 * 0.5)
        self.cv1 = ConvAct(c1, c, 1)
        self.cv2 = ConvAct(c1, c, 1)
        self.cv3 = ConvAct(2 * c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(c, c, 1, 3) for _ in range(n))
        self.shortcut = shortcut

    def forward(self, x) -> torch.Tensor:
        """``x``: a tensor, or the fused neck's ("lazy_up_concat", x_small,
        y_skip), which both branches take."""
        if isinstance(x, tuple):
            a, b = self.cv1.up_concat(x[1], x[2]), self.cv2.up_concat(x[1], x[2])
        else:
            a, b = self.cv1(x), self.cv2(x)
        for blk in self.m:
            a = blk(a, self.shortcut)
        return self.cv3(torch.cat([a, b], dim=1))


class SPPF(nn.Module):
    def __init__(self, c1: int, c2: int, k: int):
        super().__init__()
        c = c1 // 2
        self.cv1 = ConvAct(c1, c, 1)
        self.cv2 = ConvAct(c * 4, c2, 1)
        self.k = k

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        p1 = max_pool(y, self.k)
        p2 = max_pool(p1, self.k)
        p3 = max_pool(p2, self.k)
        return self.cv2(torch.cat([y, p1, p2, p3], dim=1))


class DetectV8(nn.Module):
    """Decoupled v8 head: per level a box branch (cv2, 64 DFL logits) and a
    class branch (cv3, nc logits), each conv3x3 -> conv3x3 -> conv1x1."""

    def __init__(self, ch: Sequence[int], nc: int):
        super().__init__()
        c2 = max(16, ch[0] // 4, REG_MAX * 4)
        c3 = max(ch[0], min(nc, 100))
        self.nc = nc
        self.cv2 = nn.ModuleList(
            nn.ModuleList([ConvAct(c, c2, 3), ConvAct(c2, c2, 3),
                           ConvAct(c2, 4 * REG_MAX, 1, act=False)])
            for c in ch
        )
        self.cv3 = nn.ModuleList(
            nn.ModuleList([ConvAct(c, c3, 3), ConvAct(c3, c3, 3),
                           ConvAct(c3, nc, 1, act=False)])
            for c in ch
        )

    def forward(self, feats: Sequence[torch.Tensor], reduce_scores: bool,
                decode: str) -> Dict[str, torch.Tensor]:
        levels = []
        for lvl, x in enumerate(feats):
            box_f, cls_f = x, x
            for blk in self.cv2[lvl]:
                box_f = blk(box_f)
            for blk in self.cv3[lvl]:
                cls_f = blk(cls_f)
            levels.append((box_f, cls_f))
        return self.decode(levels, reduce_scores, decode)

    def decode(self, logits: Sequence[Tuple[torch.Tensor, torch.Tensor]],
               reduce_scores: bool, decode: str) -> Dict[str, torch.Tensor]:
        """Each level's (box, class) logits, NCHW -> the decoded outputs."""
        # NHWC views of the channels_last logits (a no-op layout check:
        # convs on channels_last inputs already return channels_last)
        levels = [(b.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1),
                   c.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1))
                  for b, c in logits]
        strides = [float(s) for s in STRIDES[:len(levels)]]
        if reduce_scores:
            # the whole head in one call: on the card one launch that writes
            # the concatenated outputs
            fn = decode_v8_levels if decode != "off" else decode_v8_levels_plain
            boxes, conf, cls_ids = fn(levels, strides)
            return {"boxes_xyxy": boxes, "conf": conf, "cls": cls_ids}
        boxes, _, _ = decode_v8_levels_plain(levels, strides)
        scores = [torch.sigmoid(c.to(torch.float32)).flatten(1, 2) for _, c in levels]
        return {"boxes_xyxy": boxes, "scores": torch.cat(scores, dim=1)}


class DetectV5(nn.Module):
    """Anchor-based v5 head: one 1x1 conv per level to na * (nc + 5)
    channels, ordered (anchor, [x, y, w, h, obj, classes...]). Params tree:
    {"m": [conv per level], "anchors": [3, na, 2] input pixels}."""

    def __init__(self, ch: Sequence[int], nc: int):
        super().__init__()
        self.nc, self.na = nc, len(V5_ANCHORS[0])
        self.m = nn.ModuleList(ConvAct(c, self.na * (nc + 5), 1, act=False) for c in ch)
        self.register_buffer("anchors", torch.tensor(V5_ANCHORS, dtype=torch.float32))

    def load_tree(self, node, path: str) -> None:
        if len(node["m"]) != len(self.m):
            raise ValueError(f"{path}.m: tree has {len(node['m'])} levels, module {len(self.m)}")
        for j, conv in enumerate(self.m):
            conv.load_tree(node["m"][j], f"{path}.m.{j}")
        anchors = np.array(node.get("anchors", V5_ANCHORS), np.float32)  # a writable copy
        if anchors.shape != tuple(self.anchors.shape):
            raise ValueError(f"{path}.anchors: {anchors.shape} is not {tuple(self.anchors.shape)}")
        with torch.no_grad():
            self.anchors.copy_(torch.from_numpy(anchors))

    def to_tree(self):
        return {"m": [conv.to_tree() for conv in self.m],
                "anchors": self.anchors.detach().float().cpu().numpy().copy()}

    def forward(self, feats: Sequence[torch.Tensor],
                reduce_scores: bool) -> Dict[str, torch.Tensor]:
        return self.decode([self.raw(lvl, x) for lvl, x in enumerate(feats)], reduce_scores)

    def raw(self, lvl: int, x: torch.Tensor) -> torch.Tensor:
        """Level ``lvl``'s conv output, NCHW: weight-only, also for int8
        weights (JAX ``_detect_v5``), the bias added to the rounded conv
        output, as the JAX conv2d."""
        conv = self.m[lvl]
        return conv2d(x, conv.plain_weight(x.dtype)) + conv.bias.to(x.dtype)[:, None, None]

    def decode(self, raws: Sequence[torch.Tensor],
               reduce_scores: bool) -> Dict[str, torch.Tensor]:
        boxes_all, scores_all, conf_all, cls_all = [], [], [], []
        for lvl, conv_out in enumerate(raws):
            stride = float(STRIDES[lvl])
            n, _, h, w = conv_out.shape
            dev = conv_out.device
            raw = conv_out.permute(0, 2, 3, 1).reshape(n, h, w, self.na, self.nc + 5)
            y = torch.sigmoid(raw[..., :5].to(torch.float32))
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=dev),
                torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
            anchors = self.anchors[lvl].to(torch.float32)  # [na, 2] input px
            cx = (y[..., 0] * 2.0 - 0.5 + gx[..., None]) * stride
            cy = (y[..., 1] * 2.0 - 0.5 + gy[..., None]) * stride
            bw = (y[..., 2] * 2.0) ** 2 * anchors[:, 0]
            bh = (y[..., 3] * 2.0) ** 2 * anchors[:, 1]
            boxes_all.append(torch.stack(
                [cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], dim=-1
            ).reshape(n, h * w * self.na, 4))
            obj = y[..., 4]
            if reduce_scores:
                # conf = sigmoid(obj) * max(sigmoid(cls)): the max runs on
                # the raw logits (sigmoid is monotonic)
                logits = raw[..., 5:]
                best = logits.amax(dim=-1).to(torch.float32)
                conf_all.append((obj * torch.sigmoid(best)).reshape(n, -1))
                cls_all.append(logits.argmax(dim=-1).to(torch.int32).reshape(n, -1))
            else:
                probs = torch.sigmoid(raw[..., 5:].to(torch.float32))
                scores_all.append((probs * obj[..., None]).reshape(n, -1, self.nc))
        out = {"boxes_xyxy": torch.cat(boxes_all, dim=1)}
        if reduce_scores:
            out["conf"] = torch.cat(conf_all, dim=1)
            out["cls"] = torch.cat(cls_all, dim=1)
        else:
            out["scores"] = torch.cat(scores_all, dim=1)
        return out


class S2DPrepared(nn.Module):
    """The s2d prefix's scattered conv weights (``YoloModel.prepare_s2d``),
    as buffers, so that an exported program takes them as inputs, and
    their geometry; keyed by the conv's name in the prefix (``2.m.0.cv1``;
    a buffer name holds no dot)."""

    def __init__(self):
        super().__init__()
        self.geometry: Dict[str, Tuple[int, Tuple[int, int]]] = {}

    def put(self, name: str, wp: S2DWeight) -> None:
        self.register_buffer(name.replace(".", "_"), wp[0], persistent=False)
        self.geometry[name] = wp[1:]

    def get(self, name: str) -> S2DWeight:
        return (getattr(self, name.replace(".", "_")), *self.geometry[name])


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class YoloModel(nn.Module):
    """YOLOv5 / YOLOv8 graph + decode. ``pallas_stem`` / ``pallas_decode``
    are "off" (plain path) or "on" (the kernel wrappers: the CUDA kernel on
    a card, the plain version on the CPU); the engine sets them from
    config. ``fuse_neck`` is a model attribute, as in the JAX package (no
    config key)."""

    def __init__(self, version: int, size: str, nc: int, nodes: List[Node],
                 channels: List[int], head_srcs: List[int]):
        super().__init__()
        self.version, self.size, self.nc = version, size, nc
        self.nodes, self.channels = nodes, channels
        self.detect_ch = [channels[i] for i in head_srcs]
        self.head_idx = len(nodes) - 1
        self.pallas_stem = "off"
        self.pallas_decode = "off"
        self.fuse_neck = True
        self._fusions: Optional[Dict[int, str]] = None
        self._s2d_ok: Optional[bool] = None
        self.s2d_prep: Optional[S2DPrepared] = None  # prepare_s2d's weights
        self.layers = nn.ModuleDict()
        for i, node in enumerate(nodes):
            mod = self._make_node(i, node)
            if mod is not None:
                self.layers[str(i)] = mod

    def _cin(self, i: int, node: Node) -> List[int]:
        srcs = [s if s >= 0 else i - 1 for s in node.src]
        return [self.channels[s] if s >= 0 else 3 for s in srcs]

    def _make_node(self, i: int, node: Node) -> Optional[nn.Module]:
        cins = self._cin(i, node)
        if node.kind == "conv":
            return ConvAct(cins[0], node.c2, node.k, node.s, node.p)
        if node.kind == "c2f":
            return C2f(cins[0], node.c2, node.n, node.shortcut)
        if node.kind == "c3":
            return C3(cins[0], node.c2, node.n, node.shortcut)
        if node.kind == "sppf":
            return SPPF(cins[0], node.c2, node.k)
        if node.kind == "detect_v8":
            return DetectV8(cins, self.nc)
        if node.kind == "detect_v5":
            return DetectV5(cins, self.nc)
        return None

    @property
    def act_int8(self) -> bool:
        """The convs hold int8 weights (``weights.quantize_params_int8``),
        so they run the int8 conv: the JAX package's ``act_int8`` on a
        quantised tree."""
        return getattr(self.layers["0"], "w_q", None) is not None  # (a TpSplit: float)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Seeded He-normal init with the reference's conventions: zero
        biases; v8: DFL box biases 1, class biases log(0.01/0.99); v5:
        objectness biases log(8 / (640 / stride)^2), class biases
        log(0.6 / (nc - 0.999999)) (random-init models stay quiet). The
        numbers differ from the JAX init's (another generator); tests carry
        weights across instead."""
        for mod in self.modules():
            if isinstance(mod, ConvAct):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(
                    torch.randn(mod.weight.shape, generator=generator)
                    * math.sqrt(2.0 / max(1, fan_in))
                )
                mod.bias.zero_()
        head = self.layers[str(self.head_idx)]
        if isinstance(head, DetectV5):
            for lvl, conv in enumerate(head.m):
                b = conv.bias.view(head.na, self.nc + 5)
                b[:, 4] = math.log(8.0 / (640.0 / STRIDES[lvl]) ** 2)
                b[:, 5:] = math.log(0.6 / (self.nc - 0.999999)) if self.nc > 1 else 0.0
            return
        for lvl in range(len(head.cv2)):
            head.cv2[lvl][2].bias.fill_(1.0)
            head.cv3[lvl][2].bias.fill_(math.log(0.01 / 0.99))

    def _neck_fusions(self) -> Dict[int, str]:
        """Indices of fusable upsample -> concat(up, skip) -> c2f/c3
        triples (the JAX package's rule): the upsample and the concat must
        each have exactly one consumer, the next node, so deferring them
        cannot change any other path."""
        if self._fusions is None:
            consumers: Dict[int, List[int]] = {}
            for j, nd in enumerate(self.nodes):
                for s in nd.src:
                    consumers.setdefault(s if s >= 0 else j - 1, []).append(j)
            fus: Dict[int, str] = {}
            for i, nd in enumerate(self.nodes):
                if nd.kind != "upsample" or i + 2 >= len(self.nodes):
                    continue
                cat, blk = self.nodes[i + 1], self.nodes[i + 2]
                if cat.kind != "concat" or len(cat.src) != 2:
                    continue
                if (cat.src[0] if cat.src[0] >= 0 else i) != i:
                    continue
                if blk.kind not in ("c2f", "c3"):
                    continue
                if [s if s >= 0 else i + 1 for s in blk.src] != [i + 1]:
                    continue
                if consumers.get(i) != [i + 1] or consumers.get(i + 1) != [i + 2]:
                    continue
                fus[i] = "up"
                fus[i + 1] = "cat"
            self._fusions = fus
        return self._fusions

    def prepare_neck(self) -> None:
        """Keep the split 1x1 weight halves of every fused junction's block
        (``ConvAct.split_input`` at the upsampled tensor's width), once, on
        the weights as they now are: a serving model's preparation."""
        if self.act_int8:
            return
        for i, kind in self._neck_fusions().items():
            if kind == "up":
                blk = self.layers[str(i + 2)]
                for conv in ((blk.cv1, blk.cv2) if isinstance(blk, C3) else (blk.cv1,)):
                    conv.split_input(self.channels[i])

    def _s2d_prefix_ok(self) -> bool:
        """The s2d prefix covers nodes 0..3 = conv(s2), conv(s2), c2f/c3,
        conv(s2) with strictly chained single consumers: every published
        v5/v8 layout (the JAX package's rule)."""
        if self._s2d_ok is None:
            ok = len(self.nodes) > 4
            if ok:
                n0, n1, n2, n3 = self.nodes[:4]
                ok = (n0.kind == "conv" and n0.s == 2
                      and n1.kind == "conv" and n1.s == 2 and n1.k == 3
                      and n2.kind in ("c2f", "c3")
                      and n3.kind == "conv" and n3.s == 2 and n3.k == 3)
            if ok:
                consumers: Dict[int, List[int]] = {}
                for j, nd in enumerate(self.nodes):
                    for s in nd.src:
                        consumers.setdefault(s if s >= 0 else j - 1, []).append(j)
                ok = all(consumers.get(i) == [i + 1] for i in range(3))
            self._s2d_ok = ok
        return self._s2d_ok

    def prepare_s2d(self) -> None:
        """Scatter the s2d prefix's conv weights (``models/s2d.py``) once,
        on the weights as they now are: a serving model's preparation (a
        load drops them). Under tp the prefix reads these whole."""
        self.s2d_prep = None
        if self.act_int8 or not self._s2d_prefix_ok():
            return
        prep = S2DPrepared()
        for name, conv, fi, fo, stride in prefix_convs(self):
            prep.put(name, plain_scatter(conv, fi, fo, stride))
        self.s2d_prep = prep

    def _apply_s2d_prefix(self, xc: torch.Tensor,
                          w0: Optional[torch.Tensor]) -> torch.Tensor:
        """Nodes 0..3 in space-to-depth layout on the NCHW input ``xc``;
        returns node 3's output in the normal layout. ``w0``: node 0's
        scattered override weight (the engine's folded stem)."""
        weights = plain_scatter  # scattered here, or prepared once:
        if self.s2d_prep is not None:
            names = {id(conv): name for name, conv, *_ in prefix_convs(self)}

            def weights(conv, fi, fo, stride):
                return self.s2d_prep.get(names[id(conv)])

        l0, l1, blk, l3 = (self.layers[str(i)] for i in range(4))
        y = space_to_depth(xc, 4)  # [N, 48, H/4, W/4]
        y = s2d_conv(y, w0 if w0 is not None else weights(l0, 4, 2, 2), l0.bias, 2)
        y = s2d_conv(y, weights(l1, 2, 2, 2), l1.bias, 2)
        block = c2f_s2d if self.nodes[2].kind == "c2f" else c3_s2d
        y = block(blk, y, 2, weights)
        return s2d_conv(y, weights(l3, 2, 1, 2), l3.bias, 1)

    def stem_ok(self, h: int, w: int, dtype: torch.dtype = torch.float32) -> bool:
        """The fused stem applies: the stem nodes fit with float weights
        (``stem_nodes_ok``) and the input geometry passes the kernel's gate
        for ``dtype`` (ops/stem.stem_geometry_ok)."""
        return self.stem_nodes_ok() and stem_geometry_ok(
            h, w, self.channels[0], self.channels[1], dtype)

    def stem_nodes_ok(self) -> bool:
        """Nodes 0 and 1 are k3-s2 convs with single consumers (every
        published v8 layout; not v5, whose stem is k6) and float weights
        (not ``act_int8``: the kernel computes in bf16 / fp32)."""
        if self.act_int8 or len(self.nodes) < 3:
            return False
        n0, n1 = self.nodes[:2]
        if not (n0.kind == n1.kind == "conv" and n0.k == n1.k == 3
                and n0.s == n1.s == 2 and n0.p in (None, 1) and n1.p in (None, 1)):
            return False
        consumers: Dict[int, List[int]] = {}
        for j, nd in enumerate(self.nodes):
            for s in nd.src:
                consumers.setdefault(s if s >= 0 else j - 1, []).append(j)
        return all(consumers.get(i) == [i + 1] for i in range(2))

    def stem_weights(self, dtype: torch.dtype,
                     w0: Optional[torch.Tensor] = None) -> StemWeights:
        """Nodes 0 + 1 laid out for the fused stem (``w0`` overrides node
        0's weight, e.g. the engine's BGR//255-folded stem)."""
        l0, l1 = self.layers["0"], self.layers["1"]
        return prepare_stem(l0.weight if w0 is None else w0, l0.bias,
                            l1.weight, l1.bias, dtype)

    def forward(
        self, x: torch.Tensor, reduce_scores: bool = False, *,
        w0: Optional[torch.Tensor] = None,
        stem_weights: Optional[StemWeights] = None,
        s2d: bool = False,
        s2d_w0: Optional[S2DWeight] = None,
    ) -> Dict[str, torch.Tensor]:
        """x: [N, H, W, 3] NHWC (RGB in [0, 1], or raw pixels when ``w0``
        is a folded stem weight). Returns {"boxes_xyxy": [N, A, 4]} plus
        {"scores": [N, A, nc]} or, with ``reduce_scores``, {"conf": [N, A],
        "cls": [N, A] int32}. ``stem_weights``: the fused stem's prepared
        weights (else prepared here from the module and ``w0``). ``s2d``:
        run nodes 0-3 as the s2d prefix where it applies (float weights, H
        and W multiples of 4), before B3, as the JAX package's ``apply``;
        ``s2d_w0``: ``w0`` scattered (else scattered here)."""
        outs: List = [None] * len(self.nodes)
        fus = self._neck_fusions() if self.fuse_neck and not self.act_int8 else {}
        xc = x.permute(0, 3, 1, 2)  # NCHW view in channels_last memory
        prev = xc
        start = 0
        if (s2d and not self.act_int8 and self._s2d_prefix_ok()
                and x.shape[1] % 4 == 0 and x.shape[2] % 4 == 0):
            if s2d_w0 is None and w0 is not None:
                s2d_w0 = s2d_conv_weight(w0, 4, 2, 2, self.nodes[0].p)
            outs[3] = self._apply_s2d_prefix(xc, s2d_w0)
            prev = outs[3]
            start = 4
        elif self.pallas_stem != "off" and self.stem_ok(x.shape[1], x.shape[2], x.dtype):
            sw = stem_weights or self.stem_weights(x.dtype, w0)
            outs[1] = fused_stem_p1p2(x.contiguous(), sw).permute(0, 3, 1, 2)
            prev = outs[1]
            start = 2
        for i, node in enumerate(self.nodes):
            if i < start:
                continue
            srcs = [s if s >= 0 else i - 1 for s in node.src]
            ins = [prev if s == i - 1 and i > 0 else outs[s] for s in srcs]
            if i == 0:
                ins = [xc]
            mod = self.layers[str(i)] if str(i) in self.layers else None
            if node.kind == "conv":
                y = mod(ins[0], weight=w0 if i == 0 else None)
            elif node.kind in ("c2f", "c3", "sppf"):
                y = mod(ins[0])
            elif node.kind == "upsample":
                # a fused junction defers the upsample into the block's 1x1
                y = ("lazy_up", ins[0]) if i in fus else upsample2x(ins[0])
            elif node.kind == "concat":
                y = (("lazy_up_concat", ins[0][1], ins[1]) if i in fus
                     else torch.cat(ins, dim=1))
            elif node.kind == "detect_v8":
                return mod(ins, reduce_scores, self.pallas_decode)
            elif node.kind == "detect_v5":
                return mod(ins, reduce_scores)
            else:  # pragma: no cover
                raise ValueError(f"unknown node kind {node.kind}")
            outs[i] = y
            prev = y
        raise ValueError("graph has no detect head")  # pragma: no cover

    def num_anchors(self, input_hw: Tuple[int, int]) -> int:
        h, w = input_hw
        total = sum((h // s) * (w // s) for s in STRIDES)
        return total * (len(V5_ANCHORS[0]) if self.version == 5 else 1)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def _v8_graph(size: str, nc: int) -> Tuple[List[Node], List[int], List[int]]:
    d, wmul, maxc = V8_SCALES[size]

    def ch(c):
        return make_divisible(min(c, maxc) * wmul, 8)

    def rep(n):
        return max(round(n * d), 1)

    N = Node
    nodes = [
        N("conv", (-1,), ch(64), k=3, s=2),                      # 0 P1
        N("conv", (-1,), ch(128), k=3, s=2),                     # 1 P2
        N("c2f", (-1,), ch(128), n=rep(3), shortcut=True),       # 2
        N("conv", (-1,), ch(256), k=3, s=2),                     # 3 P3
        N("c2f", (-1,), ch(256), n=rep(6), shortcut=True),       # 4
        N("conv", (-1,), ch(512), k=3, s=2),                     # 5 P4
        N("c2f", (-1,), ch(512), n=rep(6), shortcut=True),       # 6
        N("conv", (-1,), ch(1024), k=3, s=2),                    # 7 P5
        N("c2f", (-1,), ch(1024), n=rep(3), shortcut=True),      # 8
        N("sppf", (-1,), ch(1024), k=5),                         # 9
        N("upsample", (-1,)),                                    # 10
        N("concat", (-1, 6)),                                    # 11
        N("c2f", (-1,), ch(512), n=rep(3), shortcut=False),      # 12
        N("upsample", (-1,)),                                    # 13
        N("concat", (-1, 4)),                                    # 14
        N("c2f", (-1,), ch(256), n=rep(3), shortcut=False),      # 15 P3 out
        N("conv", (-1,), ch(256), k=3, s=2),                     # 16
        N("concat", (-1, 12)),                                   # 17
        N("c2f", (-1,), ch(512), n=rep(3), shortcut=False),      # 18 P4 out
        N("conv", (-1,), ch(512), k=3, s=2),                     # 19
        N("concat", (-1, 9)),                                    # 20
        N("c2f", (-1,), ch(1024), n=rep(3), shortcut=False),     # 21 P5 out
        N("detect_v8", (15, 18, 21), nc),                        # 22
    ]
    return nodes, _infer_channels(nodes), [15, 18, 21]


def _v5_graph(size: str, nc: int) -> Tuple[List[Node], List[int], List[int]]:
    d, wmul = V5_SCALES[size]

    def ch(c):
        return make_divisible(c * wmul, 8)

    def rep(n):
        return max(round(n * d), 1)

    N = Node
    nodes = [
        N("conv", (-1,), ch(64), k=6, s=2, p=2),                 # 0 P1
        N("conv", (-1,), ch(128), k=3, s=2),                     # 1 P2
        N("c3", (-1,), ch(128), n=rep(3), shortcut=True),        # 2
        N("conv", (-1,), ch(256), k=3, s=2),                     # 3 P3
        N("c3", (-1,), ch(256), n=rep(6), shortcut=True),        # 4
        N("conv", (-1,), ch(512), k=3, s=2),                     # 5 P4
        N("c3", (-1,), ch(512), n=rep(9), shortcut=True),        # 6
        N("conv", (-1,), ch(1024), k=3, s=2),                    # 7 P5
        N("c3", (-1,), ch(1024), n=rep(3), shortcut=True),       # 8
        N("sppf", (-1,), ch(1024), k=5),                         # 9
        N("conv", (-1,), ch(512), k=1, s=1),                     # 10
        N("upsample", (-1,)),                                    # 11
        N("concat", (-1, 6)),                                    # 12
        N("c3", (-1,), ch(512), n=rep(3), shortcut=False),       # 13
        N("conv", (-1,), ch(256), k=1, s=1),                     # 14
        N("upsample", (-1,)),                                    # 15
        N("concat", (-1, 4)),                                    # 16
        N("c3", (-1,), ch(256), n=rep(3), shortcut=False),       # 17 P3 out
        N("conv", (-1,), ch(256), k=3, s=2),                     # 18
        N("concat", (-1, 14)),                                   # 19
        N("c3", (-1,), ch(512), n=rep(3), shortcut=False),       # 20 P4 out
        N("conv", (-1,), ch(512), k=3, s=2),                     # 21
        N("concat", (-1, 10)),                                   # 22
        N("c3", (-1,), ch(1024), n=rep(3), shortcut=False),      # 23 P5 out
        N("detect_v5", (17, 20, 23), nc),                        # 24
    ]
    return nodes, _infer_channels(nodes), [17, 20, 23]


def _infer_channels(nodes: List[Node]) -> List[int]:
    channels: List[int] = []
    for i, node in enumerate(nodes):
        srcs = [s if s >= 0 else i - 1 for s in node.src]
        if node.kind == "concat":
            channels.append(sum(channels[s] if s >= 0 else 3 for s in srcs))
        elif node.kind == "upsample":
            channels.append(channels[srcs[0]] if srcs[0] >= 0 else 3)
        elif node.kind.startswith("detect"):
            channels.append(0)
        else:
            channels.append(node.c2)
    return channels


def build_yolo(model_type: str = "yolov8", size: str = "n", nc: int = 80) -> YoloModel:
    """Build a YOLO model. ``model_type`` in {yolov5, yolov8}."""
    if model_type == "yolov8":
        return YoloModel(8, size, nc, *_v8_graph(size, nc))
    if model_type == "yolov5":
        return YoloModel(5, size, nc, *_v5_graph(size, nc))
    raise ValueError(f"unsupported YOLO model_type: {model_type}")


def size_from_model_path(model_path: str, default: str = "n") -> str:
    """Infer n/s/m/l/x from names like 'yolov8s.pt' (engine convenience)."""
    stem = model_path.rsplit("/", 1)[-1].lower()
    for tag in ("yolov8", "yolov5"):
        j = stem.find(tag)
        if j >= 0 and len(stem) > j + len(tag):
            c = stem[j + len(tag)]
            if c in "nsmlx":
                return c
    return default
