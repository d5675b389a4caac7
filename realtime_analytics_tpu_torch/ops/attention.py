"""B8: MViTv2's pooled attention with the decomposed relative-position bias, in one pass.

No Pallas kernel stands behind this one: the JAX package has no MViT.
``models/mvit.py`` hands each block's pooled q, k and v ([B, heads, N, D],
cls token first) and the three per-query tables of the decomposed bias
(``rel_t``, ``rel_h``, ``rel_w``: [B, heads, Nq - 1, k_t|k_h|k_w], made
from the unscaled pooled q by small matmuls) to ``rel_pos_attention``,
which returns::

    attn = (q * scale) @ k^T
    attn[:, :, 1:, 1:] += rel_t[.., t(j)] + rel_h[.., h(j)] + rel_w[.., w(j)]
    o = softmax(attn) @ v
    o[:, :, 1:] += q[:, :, 1:]                       (residual pooling)

as [B, Nq, heads * D], ready for the block's ``proj``; key j > 0 lies at
``(t, h, w)`` of the pooled [k_t, k_h, k_w] grid (``j - 1 = (t k_h + h)
k_w + w``). ``rel_pos_attention_plain`` is that composition in plain
PyTorch, the bias materialised as PySlowFast materialises it; the wrapper
takes it only for tensors on the CPU. On the card ``csrc/attention.cu``
computes the same in one pass (bf16, fp32 sums, an online softmax) and
never writes the [Nq, Nk] logits: head dim 96 (MViTv2's), bf16 operands,
``k_t + k_h + k_w <= MAX_REL``; another CUDA input is refused.

The registered op ``rva::rel_pos_attention`` is the functional form an
exported step would keep as one node (a CUDA implementation that launches
the kernel, the plain version on the CPU, a fake); the wrapper calls it
inside ``_cuda.through_ops``.
"""

from __future__ import annotations

import torch

from . import _cuda

HEAD_DIM = 96  # the kernel's head dim
MAX_REL = 64  # k_t + k_h + k_w at most (the rows' tables in shared memory)

_launch = None  # the bound C entry, set at the first launch


def rel_pos_bias(rel_t: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor) -> torch.Tensor:
    """The materialised bias [B, heads, Nq - 1, k_t * k_h * k_w] of the tables."""
    b, h, n, kt = rel_t.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    bias = (rel_t[..., :, None, None] + rel_h[..., None, :, None]
            + rel_w[..., None, None, :])
    return bias.reshape(b, h, n, kt * kh * kw)


def rel_pos_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            rel_t: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """Plain PyTorch version, any device (see the module's docstring)."""
    b, heads, nq, d = q.shape
    attn = (q * scale) @ k.transpose(-2, -1)
    attn[:, :, 1:, 1:] += rel_pos_bias(rel_t, rel_h, rel_w).to(attn.dtype)
    o = attn.softmax(dim=-1) @ v
    o[:, :, 1:] += q[:, :, 1:]
    return o.transpose(1, 2).reshape(b, nq, heads * d)


def rel_pos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, rel_t: torch.Tensor,
                      rel_h: torch.Tensor, rel_w: torch.Tensor, scale: float) -> torch.Tensor:
    """[B, Nq, heads * D]: the kernel on the card, the plain version on the
    CPU, the registered op inside ``_cuda.through_ops``."""
    if _cuda.routed_through_ops():
        return torch.ops.rva.rel_pos_attention(q, k, v, rel_t, rel_h, rel_w, float(scale))
    if not q.is_cuda:
        if q.device.type == "cpu":
            return rel_pos_attention_plain(q, k, v, rel_t, rel_h, rel_w, scale)
        raise ValueError(
            f"rel_pos_attention: q must be on a CUDA device or the CPU, got {q.device}")
    return _rel_pos_attention_cuda(q, k, v, rel_t, rel_h, rel_w, scale)


def _rel_pos_attention_cuda(q, k, v, rel_t, rel_h, rel_w, scale: float) -> torch.Tensor:
    """The checks and the launch on CUDA tensors."""
    global _launch
    tensors = (q, k, v, rel_t, rel_h, rel_w)
    dev = _cuda.require_cuda("rel_pos_attention", *tensors).index
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError("rel_pos_attention: the kernel takes bfloat16 operands, got "
                        f"{[t.dtype for t in tensors]}")
    b, heads, nq, d = q.shape
    nk = k.shape[2]
    kt, kh, kw = rel_t.shape[-1], rel_h.shape[-1], rel_w.shape[-1]
    if d != HEAD_DIM:
        raise ValueError(f"rel_pos_attention: head dim {HEAD_DIM} only, got {d}")
    if k.shape != (b, heads, nk, d) or v.shape != k.shape:
        raise ValueError(f"rel_pos_attention: k and v must be [{b}, {heads}, Nk, {d}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    for t, width in ((rel_t, kt), (rel_h, kh), (rel_w, kw)):
        if t.shape != (b, heads, nq - 1, width):
            raise ValueError(f"rel_pos_attention: a table must be [{b}, {heads}, {nq - 1}, k], "
                             f"got {tuple(t.shape)}")
    if kt * kh * kw + 1 != nk:
        raise ValueError(f"rel_pos_attention: {nk} keys are not cls + {kt} x {kh} x {kw}")
    if kt + kh + kw > MAX_REL:
        raise ValueError(f"rel_pos_attention: k_t + k_h + k_w is at most {MAX_REL}")
    q, k, v, rel_t, rel_h, rel_w = (t.contiguous() for t in tensors)
    out = torch.empty((b, nq, heads * d), dtype=q.dtype, device=q.device)
    if _launch is None:
        _launch = _cuda.entry("rva_rel_pos_attention")
    rc = _launch(dev, q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_t.data_ptr(),
                 rel_h.data_ptr(), rel_w.data_ptr(), out.data_ptr(), b * heads, heads, nq, nk,
                 kt, kh, kw, float(scale), _cuda.stream_of(dev))
    if rc:
        _cuda.fail(rc, "rel_pos_attention")
    _cuda.LAUNCHES.add("rel_pos_attention")
    return out


@torch.library.custom_op("rva::rel_pos_attention", mutates_args=(), device_types="cpu")
def _rel_pos_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          rel_t: torch.Tensor, rel_h: torch.Tensor, rel_w: torch.Tensor,
                          scale: float) -> torch.Tensor:
    return rel_pos_attention_plain(q, k, v, rel_t, rel_h, rel_w, scale)


@_rel_pos_attention_op.register_kernel("cuda")
def _(q, k, v, rel_t, rel_h, rel_w, scale: float) -> torch.Tensor:
    return _rel_pos_attention_cuda(q, k, v, rel_t, rel_h, rel_w, scale)


@_rel_pos_attention_op.register_fake
def _(q, k, v, rel_t, rel_h, rel_w, scale: float) -> torch.Tensor:
    b, heads, nq, d = q.shape
    return q.new_empty((b, nq, heads * d))
