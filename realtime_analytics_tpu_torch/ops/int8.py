"""The int8 convolution: int8 x int8 -> int32, then dequantised.

Counterpart of ``realtime_analytics_tpu/models/layers.py::conv2d_int8``,
which hands XLA's ``conv_general_dilated`` int8 operands and asks for an
int32 result. ``F.conv2d`` has no int8 path on CUDA, so here the
convolution is an im2col of the quantised NHWC activations and one
``torch._int_mm`` (an exact int32 product, on the card and on the CPU):

    x (NCHW view, channels_last memory) --quantise--> xq int8 NHWC
        --im2col--> A [M, Kp] int8, K in (ky, kx, cin) order
        --torch._int_mm(A, B.t())--> acc [M, Np] int32
        --dequantise--> acc * (act_scale * w_scale) + b, in fp32

``B`` (``pack_int8_weight``) is the OIHW weight laid out [cout, K] so that
row ``o`` equals ``w_q_hwio.reshape(K, cout)[:, o]``; its transpose is the
column-major right operand, which cuBLAS takes directly.

``torch._int_mm`` on CUDA wants M > 16 and K, N multiples of 8: rows,
columns of A and rows of B are zero-padded. A quantised zero is exact, so
padding changes no accumulator (the v8 stem's K = 27 becomes 32, the v5
stem's 108 becomes 112).

Quantisation is the JAX package's, operation for operation: divide by the
scale (not a multiply by its reciprocal), round half to even, clip to
+-127; without a calibrated ``act_scale`` the scale is
``max(max|x|, 1e-8) / 127`` over the whole batch. The dequantisation forms
``act_scale * w_scale`` first, multiplies, adds the fp32 bias and casts to
the input dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

MIN_ROWS = 17  # torch._int_mm on CUDA: M > 16
ALIGN = 8  # torch._int_mm on CUDA: K and N multiples of 8


class QuantConv(NamedTuple):
    """An int8 conv's operands: the packed weight [Np, Kp] int8
    (``pack_int8_weight``), the per-output-channel weight scale [cout] fp32
    and the static activation scale (0-d fp32, or None for the dynamic
    scale)."""

    w_pack: torch.Tensor
    w_scale: torch.Tensor
    a_scale: Optional[torch.Tensor]


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def pack_int8_weight(w_q: torch.Tensor) -> torch.Tensor:
    """OIHW int8 [cout, cin, kh, kw] -> [Np, Kp] int8, row ``o`` holding
    output channel ``o``'s taps in (ky, kx, cin) order; zero-padded to
    multiples of 8."""
    cout = w_q.shape[0]
    rows = w_q.permute(0, 2, 3, 1).reshape(cout, -1)
    k = rows.shape[1]
    out = torch.zeros((_round_up(cout, ALIGN), _round_up(k, ALIGN)), dtype=torch.int8,
                      device=w_q.device)
    out[:cout, :k] = rows
    return out


def dynamic_act_scale(x_f: torch.Tensor) -> torch.Tensor:
    """``max(max|x|, 1e-8) / 127`` over the whole tensor (0-d fp32)."""
    return torch.clamp_min(x_f.abs().amax(), 1e-8) / 127.0


def quantize_act(x_f: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """fp32 -> int8: ``clip(round(x / act_scale), -127, 127)``, half to even."""
    return torch.round(x_f / act_scale).clamp_(-127, 127).to(torch.int8)


def im2col_int8(xq: torch.Tensor, k: int, stride: int, padding: int,
                k_pad: int) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """NHWC int8 [N, H, W, C] -> (A [max(M, 17), k_pad] int8, (N, Ho, Wo)):
    row ``(n, oy, ox)`` holds the zero-padded k x k patch in (ky, kx, c)
    order, then zeros up to ``k_pad``; rows past M are zero."""
    n, h, w, c = xq.shape
    ho = (h + 2 * padding - k) // stride + 1
    wo = (w + 2 * padding - k) // stride + 1
    m = n * ho * wo
    kk = k * k * c
    rows = max(m, MIN_ROWS)
    if k == 1 and stride == 1 and padding == 0 and kk == k_pad and rows == m:
        return xq.reshape(m, kk), (n, ho, wo)  # a 1x1 conv: the activations themselves
    xp = F.pad(xq, (0, 0, padding, padding, padding, padding)) if padding else xq
    xp = xp.contiguous()
    hp, wp = xp.shape[1], xp.shape[2]
    patches = xp.as_strided((n, ho, wo, k, k, c),
                            (hp * wp * c, stride * wp * c, stride * c, wp * c, c, 1))
    if kk == k_pad and rows == m:
        return patches.reshape(m, kk), (n, ho, wo)
    a = torch.empty((rows, k_pad), dtype=torch.int8, device=xq.device)
    if k_pad > kk:
        a[:, kk:] = 0
    if rows > m:
        a[m:] = 0
    a[:m, :kk].unflatten(1, (k, k, c)).unflatten(0, (n, ho, wo)).copy_(patches)
    return a, (n, ho, wo)


def conv2d_int8_acc(x: torch.Tensor, q: QuantConv, cout: int, k: int, *, stride: int = 1,
                    padding: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int32 accumulators of the int8 conv and the activation scale
    used: x [N, C, H, W] (any memory format) -> (acc [N, Ho, Wo, cout]
    int32, act_scale 0-d fp32)."""
    if padding is None:
        padding = k // 2
    x_f = x.permute(0, 2, 3, 1).to(torch.float32)  # NHWC (a view for channels_last)
    act_scale = dynamic_act_scale(x_f) if q.a_scale is None else q.a_scale
    xq = quantize_act(x_f, act_scale)
    a, (n, ho, wo) = im2col_int8(xq, k, stride, padding, q.w_pack.shape[1])
    acc = torch._int_mm(a, q.w_pack.t())
    return acc[:n * ho * wo, :cout].unflatten(0, (n, ho, wo)), act_scale


def conv2d_int8(x: torch.Tensor, q: QuantConv, b: Optional[torch.Tensor], cout: int,
                k: int, *, stride: int = 1, padding: Optional[int] = None) -> torch.Tensor:
    """The int8 conv of ``x`` (NCHW view, any memory format) -> NCHW view
    in channels_last memory, in ``x``'s dtype: ``acc * (act_scale *
    w_scale) + b`` in fp32, then the cast."""
    acc, act_scale = conv2d_int8_acc(x, q, cout, k, stride=stride, padding=padding)
    out = acc.to(torch.float32) * (act_scale * q.w_scale.to(torch.float32))
    if b is not None:
        out = out + b.to(torch.float32)
    return out.to(x.dtype).permute(0, 3, 1, 2)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 operands, numpy ``matmul``'s
    broadcasting for rank >= 2: a [..., M, K] @ b [..., K, N] -> [..., M, N]
    int32, through ``torch._int_mm`` (rows, K and N zero-padded as
    ``pack_int8_weight`` and ``im2col_int8`` pad; a zero adds nothing). The
    ONNX graph path's ``MatMulInteger``, ``ConvInteger`` and ``QLinear*``."""
    m, k = a.shape[-2], a.shape[-1]
    n = b.shape[-1]
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    if b.ndim == 2:  # one right operand: fold a's batch into its rows
        rows = a.reshape(-1, k)
        mats = [(rows, b)]
    else:
        a_b = a.expand(*batch, m, k).reshape(-1, m, k)
        b_b = b.expand(*batch, k, n).reshape(-1, k, n)
        mats = [(a_b[i], b_b[i]) for i in range(a_b.shape[0])]
    kp, np_ = _round_up(k, ALIGN), _round_up(n, ALIGN)
    outs = []
    for lhs, rhs in mats:
        rows = lhs.shape[0]
        lp = F.pad(lhs, (0, kp - k, 0, max(rows, MIN_ROWS) - rows))
        rp = F.pad(rhs.t(), (0, kp - k, 0, np_ - n))  # [Np, Kp]: B's column-major view
        outs.append(torch._int_mm(lp, rp.t())[:rows, :n])
    if b.ndim == 2:
        return outs[0].reshape(*a.shape[:-2], m, n)
    return torch.stack(outs).reshape(*batch, m, n)
