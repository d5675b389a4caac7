"""YOLOv8 (anchor-free, DFL) as a PyTorch ``nn.Module``.

Counterpart of ``realtime_analytics_tpu/models/yolo.py``: the same
declarative node graph (indices match the published Ultralytics YAML
layouts), the same block structure and parameter names, so a JAX params
tree maps onto this module key by key (``weights.params_from_jax``).

Layout: ``forward`` takes the JAX package's NHWC input and views it as an
NCHW tensor in ``channels_last`` memory (no copy); every conv then runs
channels_last. Outputs are decoded exactly as the reference's
``YoloModel.apply``: boxes in input-pixel xyxy plus either per-class
scores or, with ``reduce_scores=True``, the per-anchor (conf, cls) pair.

Kernels on this path: the fused stem B3 (nodes 0 + 1, ``pallas_stem``) and
the head decode B2 (``pallas_decode``). ``"off"`` runs the plain
layer-by-layer path. YOLOv5 is not ported yet (ROADMAP.md), and neither
is the reference's neck fusion (an XLA HBM optimisation; plain upsample +
concat here).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.decode import REG_MAX, decode_v8_levels, decode_v8_levels_plain
from ..ops.stem import (
    StemWeights,
    fused_stem_p1p2,
    prepare_stem,
    stem_geometry_ok,
)
from .layers import ConvAct, make_divisible, max_pool, upsample2x

# ---------------------------------------------------------------------------
# Graph spec (identical to the reference)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Node:
    kind: str  # conv | c2f | sppf | upsample | concat | detect_v8
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

STRIDES = (8, 16, 32)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.cv1 = ConvAct(c1, c2, 3)
        self.cv2 = ConvAct(c2, c2, 3)

    def forward(self, x: torch.Tensor, shortcut: bool) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if shortcut and x.shape[1] == y.shape[1] else y


class C2f(nn.Module):
    def __init__(self, c1: int, c2: int, n: int, shortcut: bool):
        super().__init__()
        c = int(c2 * 0.5)
        self.cv1 = ConvAct(c1, 2 * c, 1)
        self.cv2 = ConvAct((2 + n) * c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(c, c) for _ in range(n))
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        a, b = y.chunk(2, dim=1)
        ys = [a, b]
        cur = b
        for blk in self.m:
            cur = blk(cur, self.shortcut)
            ys.append(cur)
        return self.cv2(torch.cat(ys, dim=1))


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
            # NHWC views of the channels_last logits (a no-op layout check:
            # convs on channels_last inputs already return channels_last)
            levels.append((
                box_f.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1),
                cls_f.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1),
            ))
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


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class YoloModel(nn.Module):
    """YOLOv8 graph + decode. ``pallas_stem`` / ``pallas_decode`` are
    "off" (plain path) or "on" (the kernel wrappers: the CUDA kernel on a
    card, the plain version on the CPU); the engine sets them from config."""

    def __init__(self, version: int, size: str, nc: int, nodes: List[Node],
                 channels: List[int], head_srcs: List[int]):
        super().__init__()
        self.version, self.size, self.nc = version, size, nc
        self.nodes, self.channels = nodes, channels
        self.detect_ch = [channels[i] for i in head_srcs]
        self.head_idx = len(nodes) - 1
        self.pallas_stem = "off"
        self.pallas_decode = "off"
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
        if node.kind == "sppf":
            return SPPF(cins[0], node.c2, node.k)
        if node.kind == "detect_v8":
            return DetectV8(cins, self.nc)
        return None

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Seeded He-normal init with the reference's conventions: zero
        biases, DFL box biases 1, class biases log(0.01/0.99) (random-init
        models stay quiet). The numbers differ from the JAX init's (another
        generator); tests carry weights across instead."""
        for mod in self.modules():
            if isinstance(mod, ConvAct):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(
                    torch.randn(mod.weight.shape, generator=generator)
                    * math.sqrt(2.0 / max(1, fan_in))
                )
                mod.bias.zero_()
        head = self.layers[str(self.head_idx)]
        for lvl in range(len(head.cv2)):
            head.cv2[lvl][2].bias.fill_(1.0)
            head.cv3[lvl][2].bias.fill_(math.log(0.01 / 0.99))

    def stem_ok(self, h: int, w: int, dtype: torch.dtype = torch.float32) -> bool:
        """Nodes 0 and 1 are k3-s2 convs with single consumers (every
        published v8 layout) and the input geometry passes the kernel's
        gate for ``dtype`` (ops/stem.stem_geometry_ok)."""
        if len(self.nodes) < 3:
            return False
        n0, n1 = self.nodes[:2]
        if not (n0.kind == n1.kind == "conv" and n0.k == n1.k == 3
                and n0.s == n1.s == 2 and n0.p in (None, 1) and n1.p in (None, 1)):
            return False
        consumers: Dict[int, List[int]] = {}
        for j, nd in enumerate(self.nodes):
            for s in nd.src:
                consumers.setdefault(s if s >= 0 else j - 1, []).append(j)
        if any(consumers.get(i) != [i + 1] for i in range(2)):
            return False
        return stem_geometry_ok(h, w, self.channels[0], self.channels[1], dtype)

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
    ) -> Dict[str, torch.Tensor]:
        """x: [N, H, W, 3] NHWC (RGB in [0, 1], or raw pixels when ``w0``
        is a folded stem weight). Returns {"boxes_xyxy": [N, A, 4]} plus
        {"scores": [N, A, nc]} or, with ``reduce_scores``, {"conf": [N, A],
        "cls": [N, A] int32}. ``stem_weights``: the fused stem's prepared
        weights (else prepared here from the module and ``w0``)."""
        outs: List[Optional[torch.Tensor]] = [None] * len(self.nodes)
        xc = x.permute(0, 3, 1, 2)  # NCHW view in channels_last memory
        prev = xc
        start = 0
        if self.pallas_stem != "off" and self.stem_ok(x.shape[1], x.shape[2], x.dtype):
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
            elif node.kind in ("c2f", "sppf"):
                y = mod(ins[0])
            elif node.kind == "upsample":
                y = upsample2x(ins[0])
            elif node.kind == "concat":
                y = torch.cat(ins, dim=1)
            elif node.kind == "detect_v8":
                return mod(ins, reduce_scores, self.pallas_decode)
            else:  # pragma: no cover
                raise ValueError(f"unknown node kind {node.kind}")
            outs[i] = y
            prev = y
        raise ValueError("graph has no detect head")  # pragma: no cover

    def num_anchors(self, input_hw: Tuple[int, int]) -> int:
        h, w = input_hw
        return sum((h // s) * (w // s) for s in STRIDES)


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
    """Build a YOLO model. Only ``yolov8`` is ported so far."""
    if model_type == "yolov5":
        raise NotImplementedError(
            "yolov5 is not ported to the PyTorch package yet — see "
            "ROADMAP.md (Queue A); use yolov8 or the JAX package"
        )
    if model_type != "yolov8":
        raise ValueError(f"unsupported YOLO model_type: {model_type}")
    nodes, channels, head_srcs = _v8_graph(size, nc)
    return YoloModel(8, size, nc, nodes, channels, head_srcs)


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
