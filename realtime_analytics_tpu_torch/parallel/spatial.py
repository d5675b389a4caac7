"""The sp mesh axis: a YOLO forward over image-height bands.

Counterpart of what GSPMD does with the JAX package's ``P("dp", "sp",
None, None)`` images (``realtime_analytics_tpu/parallel/train.py``): on a
(dp, sp, tp) mesh each dp row's images split by height over the row's sp
ranks, every conv, pool, upsample and concat of the backbone, the neck and
the head's convs runs on the bands, and XLA's halo exchanges
(collective-permutes) are the rows one rank fetches from another.

The band rule: an op's output of height H is owned in contiguous shares,
rank s holding rows ``[s * H // sp, (s + 1) * H // sp)`` (``band_rows``).
To compute its share a rank fetches the input rows those outputs read,
``[o0 * stride - pad, (o1 - 1) * stride - pad + k)``, from whichever ranks
hold them, and fills only what lies above the image's top or below its
bottom (zeros for a conv, -inf for a max pool); the width keeps the op's own
padding. So bands may be uneven or empty (a 2-row P5 at sp 4), and an op
may reach past its neighbour (SPPF's chained k5 pools, v5's k6 s2 p2 stem).
Ops whose output rows are their input rows (1x1 convs, SiLU, residual
adds, C2f's split and every concat) need no fetch: two tensors of one
height are banded alike. The fused neck's split 1x1 (``ConvAct.up_concat``)
computes its low-resolution half on the small bands and fetches it through
the banded upsample. The head's per-level logits are joined by height on
the row's first device before the decode (B2) and NMS, which run once a dp
shard as on a (dp, tp) mesh.

Rank (r, s) runs on ``devices[r, s, :]``: a conv whose weight is
tp-sharded (``TpSplit``) computes each tp slice on ``devices[r, s, t]``
and joins them on ``devices[r, s, 0]``; weights are copied there from row
0's (a no-op where they are the same device, a differentiable copy where
not, so a train step's gradients reach row 0's tensors). Not banded: B3
(off under any mesh), int8 weights and the s2d prefix, which no JAX entry
point runs under sp (``check_banded`` and ``banded_forward`` refuse them).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import conv_bias_act
from ..models.yolo import YoloModel

Bands = List[torch.Tensor]  # one NCHW tensor a sp rank, its rows of the image


def band_rows(h: int, sp: int) -> List[Tuple[int, int]]:
    """The rows [lo, hi) that each of ``sp`` ranks owns of a height ``h``."""
    return [(s * h // sp, (s + 1) * h // sp) for s in range(sp)]


def check_banded(model: nn.Module) -> None:
    """Raise unless ``model`` is one that ``banded_forward`` runs."""
    if not isinstance(model, YoloModel):
        raise ValueError(f"the sp axis splits YOLO images by height; a {type(model).__name__} "
                         "takes a (dp, tp) mesh")
    if model.act_int8:
        raise ValueError("int8 weights under an sp mesh axis are not supported: the int8 "
                         "conv has no banded form; use a (dp, tp) mesh")


class _Walk:
    """One dp row's banded forward: ``devs`` [sp, tp] its devices."""

    def __init__(self, devs: np.ndarray):
        self.devs = devs
        self.sp = devs.shape[0]
        self.copies = 0

    def lead(self, s: int) -> torch.device:
        return self.devs[s, 0]

    def empty(self, like: torch.Tensor, s: int, c: int, w: int) -> torch.Tensor:
        """Rank s's share of an output it owns no rows of (torch's convs,
        pools and resizes take no empty input)."""
        return like.new_empty((like.shape[0], c, 0, w), device=self.lead(s)).contiguous(
            memory_format=torch.channels_last)

    # -- fetching rows ------------------------------------------------------

    def fetch(self, bands: Bands, lo: int, hi: int, s: int, fill: float) -> torch.Tensor:
        """Rows [lo, hi) of the banded tensor on rank s's first device;
        rows outside the image are ``fill``. Each slice taken from another
        rank is one halo copy."""
        h = sum(b.shape[2] for b in bands)
        dev = self.lead(s)
        parts = []
        top, bottom = max(0, -lo), max(0, hi - h)
        ref = bands[0]
        n, c, w = ref.shape[0], ref.shape[1], ref.shape[3]
        if top:
            parts.append(ref.new_full((n, c, top, w), fill, device=dev))
        for j, (a, b) in enumerate(band_rows(h, self.sp)):
            a2, b2 = max(a, lo), min(b, hi)
            if a2 < b2:
                self.copies += j != s
                parts.append(bands[j][:, :, a2 - a:b2 - a].to(dev))
        if bottom:
            parts.append(ref.new_full((n, c, bottom, w), fill, device=dev))
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)
        return x.contiguous(memory_format=torch.channels_last)

    def windows(self, bands: Bands, h_out: int, k: int, stride: int, pad: int, fill: float):
        """(rank, window) of each rank that owns output rows of an op with
        this geometry along the height."""
        for s, (o0, o1) in enumerate(band_rows(h_out, self.sp)):
            if o1 > o0:
                yield s, self.fetch(bands, o0 * stride - pad, (o1 - 1) * stride - pad + k,
                                    s, fill)

    # -- ops ------------------------------------------------------------------

    def conv(self, mod: nn.Module, bands: Bands,
             weight: Optional[torch.Tensor] = None) -> Bands:
        """A ``ConvAct`` (or its ``TpSplit``) on the bands; ``weight``
        overrides the stored one (the engine's folded stem)."""
        first = mod.parts[0] if hasattr(mod, "parts") else mod
        k, stride = first.shape[-1], first.stride
        pad = k // 2 if first.padding is None else first.padding
        h = sum(b.shape[2] for b in bands)
        w_in = bands[0].shape[3]
        h_out = (h + 2 * pad - k) // stride + 1
        w_out = (w_in + 2 * pad - k) // stride + 1
        cout = _cout(mod) if weight is None else weight.shape[0]
        out = [self.empty(bands[0], s, cout, w_out) for s in range(self.sp)]
        for s, win in self.windows(bands, h_out, k, stride, pad, 0.0):
            out[s] = self._conv_rank(mod, win, s, weight, stride, pad)
        return out

    def _conv_rank(self, mod, x, s, weight, stride, pad):
        if not hasattr(mod, "parts"):
            return _conv_h(x, (mod.weight if weight is None else weight).to(x.device),
                           mod.bias.to(x.device), stride, pad, mod.act)
        ys = []
        for t, part in enumerate(mod.parts):
            dev = self.devs[s, t]
            w = part.weight if weight is None else weight[t * mod.step:(t + 1) * mod.step]
            ys.append(_conv_h(x.to(dev), w.to(dev), part.bias.to(dev), stride, pad, part.act))
        return torch.cat([y.to(x.device) for y in ys], dim=1)

    def pool(self, bands: Bands, k: int) -> Bands:
        """SPPF's stride-1 max pool (pad k // 2, -inf beyond the edges)."""
        h = sum(b.shape[2] for b in bands)
        out = [b[:, :, :0] for b in bands]
        for s, win in self.windows(bands, h, k, 1, k // 2, float("-inf")):
            out[s] = F.max_pool2d(win, kernel_size=k, stride=1, padding=(0, k // 2))
        return out

    def upsample(self, bands: Bands) -> Bands:
        """Nearest 2x: output row o reads input row o // 2."""
        h = sum(b.shape[2] for b in bands)
        _, c, _, w = bands[0].shape
        out = [self.empty(bands[0], s, c, 2 * w) for s in range(self.sp)]
        for s, (o0, o1) in enumerate(band_rows(2 * h, self.sp)):
            if o1 > o0:
                lo = o0 // 2
                win = self.fetch(bands, lo, (o1 + 1) // 2, s, 0.0)
                up = F.interpolate(win, scale_factor=2.0, mode="nearest")
                out[s] = up[:, :, o0 - 2 * lo:o1 - 2 * lo]
        return out

    def up_concat(self, mod: nn.Module, small: Bands, skip: Bands) -> Bands:
        """``ConvAct.up_concat`` on bands: the low-resolution half on the
        small bands, through the banded upsample, plus the skip half."""
        parts = mod.parts if hasattr(mod, "parts") else [mod]
        ch = small[0].shape[1]
        halves = []
        for part in parts:
            if part.w_up is not None and not part.weight.requires_grad:
                halves.append((part.w_up, part.w_skip, part.bias))
            else:
                halves.append((part.weight[:, :ch], part.weight[:, ch:], part.bias))

        def per_rank(bands, fn):
            out = []
            for s, x in enumerate(bands):
                if not x.shape[2]:
                    out.append(self.empty(x, s, _cout(mod), x.shape[3]))
                    continue
                ys = [fn(x.to(self.devs[s, t]), *(v.to(self.devs[s, t]) for v in halves[t]))
                      for t in range(len(parts))]
                out.append(torch.cat([y.to(x.device) for y in ys], dim=1))
            return out

        a = self.upsample(per_rank(small, lambda x, w_a, _w_b, _b: F.conv2d(x, w_a.to(x.dtype))))
        b = per_rank(skip, lambda y, _w_a, w_b, bias: F.conv2d(y, w_b.to(y.dtype))
                     + bias.to(y.dtype)[:, None, None])
        return [F.silu(ua + ub) for ua, ub in zip(a, b)]

    @staticmethod
    def cat(inputs: Sequence[Bands]) -> Bands:
        return [torch.cat(parts, dim=1) for parts in zip(*inputs)]

    def bottleneck(self, blk: nn.Module, x: Bands, shortcut: bool) -> Bands:
        y = self.conv(blk.cv2, self.conv(blk.cv1, x))
        if shortcut and x[0].shape[1] == y[0].shape[1]:
            return [a + b for a, b in zip(x, y)]
        return y

    def c2f(self, mod: nn.Module, x) -> Bands:
        y = self.up_concat(mod.cv1, x[1], x[2]) if isinstance(x, tuple) else self.conv(mod.cv1, x)
        halves = [t.chunk(2, dim=1) for t in y]
        ys = [[a for a, _ in halves], [b for _, b in halves]]
        cur = ys[1]
        for blk in mod.m:
            cur = self.bottleneck(blk, cur, mod.shortcut)
            ys.append(cur)
        return self.conv(mod.cv2, self.cat(ys))

    def c3(self, mod: nn.Module, x) -> Bands:
        if isinstance(x, tuple):
            a, b = self.up_concat(mod.cv1, x[1], x[2]), self.up_concat(mod.cv2, x[1], x[2])
        else:
            a, b = self.conv(mod.cv1, x), self.conv(mod.cv2, x)
        for blk in mod.m:
            a = self.bottleneck(blk, a, mod.shortcut)
        return self.conv(mod.cv3, self.cat([a, b]))

    def sppf(self, mod: nn.Module, x: Bands) -> Bands:
        y = self.conv(mod.cv1, x)
        p1 = self.pool(y, mod.k)
        p2 = self.pool(p1, mod.k)
        p3 = self.pool(p2, mod.k)
        return self.conv(mod.cv2, self.cat([y, p1, p2, p3]))

    def join(self, bands: Bands) -> torch.Tensor:
        """The bands joined by height on the row's first device."""
        dev = self.lead(0)
        return torch.cat([b.to(dev) for b in bands], dim=2).contiguous(
            memory_format=torch.channels_last)

    def v5_raw(self, mod: nn.Module, x: Bands) -> Bands:
        """A v5 head level's 1x1 conv (``DetectV5.raw``) on the bands, from
        the joined weight."""
        out = []
        for s, b in enumerate(x):
            if not b.shape[2]:
                out.append(self.empty(b, s, mod.bias.shape[0], b.shape[3]))
                continue
            w = mod.plain_weight(b.dtype).to(b.device)
            out.append(F.conv2d(b, w) + mod.bias.to(b.device, b.dtype)[:, None, None])
        return out


def _cout(mod: nn.Module) -> int:
    """A conv's output channels (a ``TpSplit``'s summed over its slices)."""
    return sum(p.shape[0] for p in getattr(mod, "parts", [mod]))


def _conv_h(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int, pad: int,
            act: bool) -> torch.Tensor:
    """A conv whose rows are already padded: padding only along the width
    (on the card the epilogue kernel adds the bias and applies SiLU)."""
    return conv_bias_act(x, w, b, stride=stride, padding=(0, pad), act=act)


def banded_forward(model: YoloModel, devs: np.ndarray, x: torch.Tensor,
                   reduce_scores: bool = False, *, w0: Optional[torch.Tensor] = None,
                   stem_weights=None, s2d: bool = False, s2d_w0=None):
    """``model``'s forward (``YoloModel.forward``'s arguments; B3's
    ``stem_weights`` are not used: B3 is off under a mesh; s2d is refused)
    on one dp row's
    images ``x`` [N, H, W, 3], split by height over ``devs`` [sp, tp].
    Returns (the outputs on ``devs[0, 0]``, the halo copies made). The
    model passed ``check_banded`` when its ``ShardedModel`` was made."""
    if s2d:
        raise ValueError("s2d_backbone under an sp mesh axis is not supported: no JAX "
                         "entry point runs the s2d prefix under sp; serve s2d on one device "
                         "or a (dp, tp) mesh")
    walk = _Walk(devs)
    xc = x.permute(0, 3, 1, 2)  # NCHW view in channels_last memory
    prev: object = [xc[:, :, lo:hi].to(walk.lead(s))
                    for s, (lo, hi) in enumerate(band_rows(x.shape[1], walk.sp))]
    outs: List = [None] * len(model.nodes)
    fus = model._neck_fusions() if model.fuse_neck else {}
    for i, node in enumerate(model.nodes):
        srcs = [s if s >= 0 else i - 1 for s in node.src]
        ins = [prev if s == i - 1 or i == 0 else outs[s] for s in srcs]
        mod = model.layers[str(i)] if str(i) in model.layers else None
        if node.kind == "conv":
            y = walk.conv(mod, ins[0], weight=w0 if i == 0 else None)
        elif node.kind == "c2f":
            y = walk.c2f(mod, ins[0])
        elif node.kind == "c3":
            y = walk.c3(mod, ins[0])
        elif node.kind == "sppf":
            y = walk.sppf(mod, ins[0])
        elif node.kind == "upsample":
            y = ("lazy_up", ins[0]) if i in fus else walk.upsample(ins[0])
        elif node.kind == "concat":
            y = (("lazy_up_concat", ins[0][1], ins[1]) if i in fus else walk.cat(ins))
        elif node.kind == "detect_v8":
            logits = []
            for lvl, feat in enumerate(ins):
                box_f, cls_f = feat, feat
                for blk in mod.cv2[lvl]:
                    box_f = walk.conv(blk, box_f)
                for blk in mod.cv3[lvl]:
                    cls_f = walk.conv(blk, cls_f)
                logits.append((walk.join(box_f), walk.join(cls_f)))
            return mod.decode(logits, reduce_scores, model.pallas_decode), walk.copies
        elif node.kind == "detect_v5":
            raws = [walk.join(walk.v5_raw(mod.m[lvl], feat)) for lvl, feat in enumerate(ins)]
            return mod.decode(raws, reduce_scores), walk.copies
        else:  # pragma: no cover
            raise ValueError(f"unknown node kind {node.kind}")
        outs[i] = y
        prev = y
    raise ValueError("graph has no detect head")  # pragma: no cover
