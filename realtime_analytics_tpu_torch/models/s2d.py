"""Space-to-depth (s2d) early backbone: YOLO nodes 0-3 over s2d tensors.

Counterpart of ``realtime_analytics_tpu/models/s2d.py``. s2d(f) folds each
f x f spatial block into channels, so the stem stage's tensors become
[N, 48, H/4, W/4] -> [N, 64, H/4, W/4] -> [N, 128, H/8, W/8] (YOLOv8n)
instead of 3, 16 and 32 channels at full resolution. Every conv of the
region has an exact equivalent over the s2d tensors whose weight is the
original one scattered by two constant 0/1 phase matrices, one per
spatial axis (``_phase_matrix``):

    out s-row Y, output phase q, original tap t (offset from center):
        original input row  r = stride * (fo * Y + q) + t
        s2d input position  (s-row r // fi, phase r % fi)

so ``w'[co * fo^2 + qy * fo + qx, ci * fi^2 + py * fi + px, wy, wx] =
w[co, ci, t_y + pad, t_x + pad]`` for the (window, phase) pairs the
mapping hits, and zero elsewhere. No arithmetic touches a weight value,
so the result equals the plain convs' up to accumulation order. A 1x1
conv becomes phase-diagonal, so C2f's and C3's split and concat still hold
in the channel-major order ``c * f^2 + py * f + px``, which is the JAX
package's.

Tensors are NCHW-logical in ``channels_last`` memory, as the rest of the
model. The scattered weights of a serving model are made once
(``YoloModel.prepare_s2d``), not on each call. The JAX package measured the
prefix on its TPU and keeps it off by default; on the card it runs when
``detector.s2d_backbone: on``.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

S2DWeight = Tuple[torch.Tensor, int, Tuple[int, int]]  # (w', stride', (pad_lo, pad_hi))


def space_to_depth(x: torch.Tensor, f: int) -> torch.Tensor:
    """[N, C, H, W] -> [N, C*f*f, H/f, W/f], channel-major (c*f*f + py*f + px)."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // f, f, w // f, f).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, c * f * f, h // f, w // f).contiguous(memory_format=torch.channels_last)


def depth_to_space(x: torch.Tensor, f: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    n, cf, h, w = x.shape
    c = cf // (f * f)
    x = x.reshape(n, c, f, f, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, c, h * f, w * f).contiguous(memory_format=torch.channels_last)


@functools.lru_cache(maxsize=None)
def _phase_matrix(k: int, pad: int, stride: int, fi: int,
                  fo: int) -> Tuple[np.ndarray, int, Tuple[int, int]]:
    """One axis's tap -> (window, phase) scatter matrix M[k', fi, fo, k].

    Returns (M, the s-grid stride, (pad_lo, pad_hi)). The derived conv
    reads input s-rows ``S' * Y + win`` for win in [wmin, wmax]; pad_hi
    follows from the s-grid output length H/S' (= wmax - S' + 1, whatever
    H is)."""
    if stride * fo % fi:
        raise ValueError("incompatible s2d factors")
    sp = stride * fo // fi
    vs = [stride * q + (a - pad) for q in range(fo) for a in range(k)]
    wmin = min(v // fi for v in vs)
    wmax = max(v // fi for v in vs)
    m = np.zeros((wmax - wmin + 1, fi, fo, k), np.float32)
    for q in range(fo):
        for a in range(k):
            v = stride * q + (a - pad)
            m[v // fi - wmin, v % fi, q, a] = 1.0
    return m, sp, (-wmin, wmax - sp + 1)


def s2d_conv_weight(w: torch.Tensor, fi: int, fo: int, stride: int,
                    pad: Optional[int] = None) -> S2DWeight:
    """Scatter a conv weight [co, ci, kh, kw] (OIHW) into its s2d
    equivalent [co*fo^2, ci*fi^2, k', k']; returns (w', stride', padding)."""
    co, ci, kh, kw = w.shape
    pad_ = kh // 2 if pad is None else pad
    my, sp, padding = _phase_matrix(kh, pad_, stride, fi, fo)
    mx, _, _ = _phase_matrix(kw, pad_, stride, fi, fo)
    myt = torch.from_numpy(my).to(w.device, w.dtype)
    mxt = torch.from_numpy(mx).to(w.device, w.dtype)
    # [co,ci,kh,kw] x [k'y,py,qy,kh] x [k'x,px,qx,kw] -> [co,qy,qx, ci,py,px, k'y,k'x]
    wp = torch.einsum("dcab,eufa,gvhb->dfhcuveg", w.detach(), myt, mxt)
    wp = wp.reshape(co * fo * fo, ci * fi * fi, my.shape[0], mx.shape[0])
    return wp.contiguous(memory_format=torch.channels_last), sp, padding


def s2d_conv(x: torch.Tensor, wp: S2DWeight, b: Optional[torch.Tensor], fo: int,
             act: bool = True) -> torch.Tensor:
    """conv (+ SiLU) over s2d tensors with a scattered weight (``wp``, from
    ``s2d_conv_weight``): equal, up to accumulation order, to the plain
    conv on the depth-to-space'd input. The bias repeats per output phase."""
    w, sp, (lo, hi) = wp
    bias = None if b is None else b.to(x.dtype).repeat_interleave(fo * fo)
    if lo >= hi:
        # pad both sides by lo and drop what the larger high pad adds
        _, _, h, wd = x.shape
        ho, wo = (h + lo + hi - w.shape[2]) // sp + 1, (wd + lo + hi - w.shape[3]) // sp + 1
        y = F.conv2d(x, w.to(x.dtype), bias, stride=sp, padding=lo)[:, :, :ho, :wo]
    else:
        y = F.conv2d(F.pad(x, (lo, hi, lo, hi)).contiguous(memory_format=torch.channels_last),
                     w.to(x.dtype), bias, stride=sp)
    return F.silu(y) if act else y


def s2d_conv_act(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *,
                 fi: int, fo: int, stride: int = 1, pad: Optional[int] = None,
                 act: bool = True) -> torch.Tensor:
    """conv + SiLU over s2d tensors from the plain weight ``w`` (OIHW),
    scattered here: JAX's ``s2d_conv_act``."""
    return s2d_conv(x, s2d_conv_weight(w.to(x.dtype), fi, fo, stride, pad), b, fo, act)


def _bottleneck_s2d(blk, x: torch.Tensor, shortcut: bool, fi: int, weights) -> torch.Tensor:
    y = s2d_conv(x, weights(blk.cv1, fi, fi, 1), blk.cv1.bias, fi)
    y = s2d_conv(y, weights(blk.cv2, fi, fi, 1), blk.cv2.bias, fi)
    return x + y if shortcut and x.shape[1] == y.shape[1] else y


def c2f_s2d(mod, x: torch.Tensor, fi: int, weights=None) -> torch.Tensor:
    """A ``C2f`` over an s2d tensor: the channel-major layout keeps its
    split and concat block-aligned; its 1x1 convs are phase-diagonal.
    ``weights(conv, fi, fo, stride)``: a conv's scattered weight (default:
    scattered here from the conv's weight)."""
    weights = weights or plain_scatter
    y = s2d_conv(x, weights(mod.cv1, fi, fi, 1), mod.cv1.bias, fi)
    a, b = y.chunk(2, dim=1)
    ys = [a, b]
    cur = b
    for blk in mod.m:
        cur = _bottleneck_s2d(blk, cur, mod.shortcut, fi, weights)
        ys.append(cur)
    return s2d_conv(torch.cat(ys, dim=1), weights(mod.cv2, fi, fi, 1), mod.cv2.bias, fi)


def c3_s2d(mod, x: torch.Tensor, fi: int, weights=None) -> torch.Tensor:
    """A ``C3`` over an s2d tensor (see ``c2f_s2d``)."""
    weights = weights or plain_scatter
    a = s2d_conv(x, weights(mod.cv1, fi, fi, 1), mod.cv1.bias, fi)
    b = s2d_conv(x, weights(mod.cv2, fi, fi, 1), mod.cv2.bias, fi)
    for blk in mod.m:
        a = _bottleneck_s2d(blk, a, mod.shortcut, fi, weights)
    return s2d_conv(torch.cat([a, b], dim=1), weights(mod.cv3, fi, fi, 1), mod.cv3.bias, fi)


def plain_scatter(conv, fi: int, fo: int, stride: int) -> S2DWeight:
    """A conv's weight (joined, for a tp-split conv) scattered on the call."""
    pad = getattr(conv, "parts", [conv])[0].padding
    return s2d_conv_weight(conv.weight, fi, fo, stride, pad)


def prefix_convs(model) -> Sequence[Tuple[str, object, int, int, int]]:
    """(name, conv, fi, fo, stride) of every conv of the s2d prefix, nodes
    0-3 of ``model``, in the order the prefix runs them."""
    l0, l1, blk, l3 = (model.layers[str(i)] for i in range(4))
    convs = [("0", l0, 4, 2, 2), ("1", l1, 2, 2, 2)]
    inner = [("cv1", blk.cv1), ("cv2", blk.cv2)] + ([("cv3", blk.cv3)] if hasattr(blk, "cv3")
                                                     else [])
    for j, b in enumerate(blk.m):
        inner += [(f"m.{j}.cv1", b.cv1), (f"m.{j}.cv2", b.cv2)]
    convs += [(f"2.{name}", conv, 2, 2, 1) for name, conv in inner]
    convs.append(("3", l3, 2, 1, 2))
    return convs
