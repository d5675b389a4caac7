"""MViTv2-S (Li et al., "MViTv2: Improved Multiscale Vision Transformers for
Classification and Detection", CVPR 2022) as PySlowFast builds it for
``configs/Kinetics/MVITv2_S_16x4.yaml``, served as ``model_type: mvitv2_s``.

This network has no counterpart in the JAX package. It takes
``[N, T, H, W, 3]`` normalised RGB clips, as the other temporal models do,
and returns logits ``[N, classes]`` in fp32.

* Patch embedding: a Conv3d 3 -> ``embed_dim`` (kernel 3x7x7, stride
  2x4x4, padding 1x3x3, with bias) over the clip in ``channels_last_3d``,
  its output read as tokens ``[N, T/2 * H/4 * W/4, C]`` without a copy;
  ``cls_token`` prepended. No absolute position embedding.
* Blocks (``spec.depth``; at the blocks of ``spec.stages`` the width and
  the heads double and q pools at stride (1, 2, 2); the head dim stays
  ``embed_dim / num_heads``), PySlowFast's ``MultiScaleBlock`` with
  ``DIM_MUL_IN_ATT`` and ``RESIDUAL_POOLING``, LayerNorm eps 1e-6:
  ``xn = norm1(x)``; one ``qkv`` linear; q, k and v each pooled by its own
  depthwise Conv3d (3x3x3, padding 1, shared by the heads, no bias) over
  ``[B * heads, head_dim, T, H, W]`` in NCDHW (PyTorch's depthwise 3D
  kernel; cuDNN's route for a ``channels_last_3d`` view of the tokens is a
  generic CUDA-core GEMM, ``pool_tokens``), the cls token passed around
  the pool, then LayerNormed; k and v at the adaptive stride ``spec.kv_stride`` divided by
  every q stride so far. The attention (``ops/attention.py``): logits
  ``(q * scale) @ k^T`` with the decomposed relative positions
  ``rel_t[i, t(j)] + rel_h[i, h(j)] + rel_w[i, w(j)]`` past the cls row and
  column, each table the unscaled pooled q against ``rel_pos_*`` gathered
  at PySlowFast's distances (``rel_index``, kept as buffers); softmax; ``@ v``; ``+ q`` past
  the cls row; then ``proj``. On the card that is one launch of B8 a
  block (``Attention.fused_calls`` counts them), which never writes the
  logits and takes bf16 at head dim 96 alone (``config.py`` refuses
  another compute dtype on the card); on the CPU the plain route
  materialises them. The skip is
  ``proj(xn)`` where the width changes, else ``x``, through a MaxPool3d
  (kernel 1x3x3, stride 1x2x2, padding 0x1x1) at the q-stride blocks, cls
  passed around; ``x = skip + attn``; ``x = x + fc2(gelu(fc1(norm2(x))))``
  (exact GELU).
* Head: the final ``norm`` and ``head.projection`` on the cls token, in
  fp32; softmax is the engine's.

LayerNorm, GELU and the linears are PyTorch's ops in the model's dtype.
Module and parameter names follow PySlowFast's ``model_state`` keys
(``blocks.3.attn.rel_pos_h``, ``blocks.1.proj``, ``head.projection``), so
``weights.mvit_params_from_state_dict`` reads a checkpoint key for key.

Departures from PySlowFast, none of which changes the function at a crop
that is a multiple of 32 and an even T (what ``config.py`` admits):

* the relative-position tables are sized for the configured input and
  never resized (PySlowFast's ``get_rel_pos`` interpolates a table whose
  length differs from ``2 max(q, k) - 1``, which such inputs never have);
* the final LayerNorm runs on the cls token alone, the only token the head
  reads;
* the head's softmax (``TransformerBasicHead``'s in eval mode) is the
  engine's; dropout and drop-path are the identity and are left out.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import rel_pos_attention, rel_pos_attention_plain
from .layers import load_param, to_numpy

LN_EPS = 1e-6
_COUNT = threading.Lock()  # guards every Attention's ``fused_calls``


@dataclass(frozen=True)
class BlockShape:
    """One block's widths, heads and token grids (cls not counted)."""

    dim: int
    dim_out: int
    heads: int
    q_stride: Tuple[int, int, int]
    kv_stride: Tuple[int, int, int]
    thw: Tuple[int, int, int]  # the block's input grid
    q_thw: Tuple[int, int, int]
    kv_thw: Tuple[int, int, int]

    @property
    def head_dim(self) -> int:
        return self.dim_out // self.heads


@dataclass(frozen=True)
class MViTSpec:
    """The network's sizes; the default is MVITv2_S_16x4 at Kinetics-400.
    ``stages``: the blocks at which ``DIM_MUL`` and ``HEAD_MUL`` double the
    width and the heads and ``POOL_Q_STRIDE`` pools q at (1, 2, 2) (every
    other block pools q at stride 1). ``num_frames`` and ``crop`` size the
    relative-position tables."""

    depth: int = 16
    embed_dim: int = 96
    num_heads: int = 1
    stages: Tuple[int, ...] = (1, 3, 14)
    kv_stride: Tuple[int, int, int] = (1, 8, 8)  # POOL_KV_STRIDE_ADAPTIVE
    pool_kernel: Tuple[int, int, int] = (3, 3, 3)
    patch_kernel: Tuple[int, int, int] = (3, 7, 7)
    patch_stride: Tuple[int, int, int] = (2, 4, 4)
    patch_padding: Tuple[int, int, int] = (1, 3, 3)
    mlp_ratio: float = 4.0
    num_frames: int = 16
    crop: int = 224
    num_classes: int = 400

    def blocks(self) -> List[BlockShape]:
        """Each block's shape, as PySlowFast's ``MViT.__init__`` derives it."""
        thw = (self.num_frames // self.patch_stride[0], self.crop // self.patch_stride[1],
               self.crop // self.patch_stride[2])
        dim, heads, kv = self.embed_dim, self.num_heads, tuple(self.kv_stride)
        out = []
        for i in range(self.depth):
            q = (1, 2, 2) if i in self.stages else (1, 1, 1)
            dim_out, heads = (2 * dim, 2 * heads) if i in self.stages else (dim, heads)
            kv = tuple(max(s // d, 1) for s, d in zip(kv, q))
            out.append(BlockShape(dim, dim_out, heads, q, kv, thw, self._pooled(thw, q),
                                  self._pooled(thw, kv)))
            thw, dim = out[-1].q_thw, dim_out
        return out

    def _pooled(self, thw, stride) -> Tuple[int, int, int]:
        return tuple((n + 2 * (k // 2) - k) // s + 1
                     for n, s, k in zip(thw, stride, self.pool_kernel))


def rel_index(q_n: int, k_n: int) -> torch.Tensor:
    """[q_n, k_n]: the table row of query i and key j along one axis,
    ``i max(k/q, 1) - j max(q/k, 1) + (k - 1) max(q/k, 1)`` (PySlowFast's
    ``dist_h``)."""
    q_ratio, k_ratio = max(k_n / q_n, 1.0), max(q_n / k_n, 1.0)
    dist = np.arange(q_n)[:, None] * q_ratio - np.arange(k_n)[None, :] * k_ratio
    return torch.from_numpy((dist + (k_n - 1) * k_ratio).astype(np.int64))


def rel_tables(q: torch.Tensor, q_thw: Tuple[int, int, int], kv_thw: Tuple[int, int, int],
               tables: Sequence[torch.Tensor], index: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """(rel_t, rel_h, rel_w) [B, heads, Nq - 1, k_t|k_h|k_w] from the
    unscaled pooled q [B, heads, Nq, D], ``tables`` (``rel_pos_t``,
    ``rel_pos_h``, ``rel_pos_w``) and ``index`` (``rel_index`` of each axis):
    each the q of a token at (t, h, w) of ``q_thw`` against the table's rows
    at its distance to each key along the axis (PySlowFast's
    ``cal_rel_pos_temporal`` / ``cal_rel_pos_spatial`` einsums)."""
    b, heads, _, d = q.shape
    r = q[:, :, 1:].reshape(b, heads, *q_thw, d)
    return [torch.einsum(eq, r, table.to(q.dtype)[idx]).reshape(b, heads, -1, k)
            for eq, table, idx, k in zip(("bythwc,tkc->bythwk", "bythwc,hkc->bythwk",
                                          "bythwc,wkc->bythwk"), tables, index, kv_thw)]


def pool_tokens(t: torch.Tensor, conv: nn.Conv3d, norm: nn.LayerNorm,
                thw: Tuple[int, int, int]) -> torch.Tensor:
    """PySlowFast's ``attention_pool`` of one of q, k, v: ``t`` [B, N, heads,
    D] (a view of the ``qkv`` output) -> [B, heads, N', D], contiguous. The
    depthwise conv runs on [B * heads, D, T, H, W] in NCDHW, PyTorch's own
    depthwise 3D kernel (one transpose in, one out): on a
    ``channels_last_3d`` view cuDNN takes a generic CUDA-core implicit GEMM
    with layout conversions, 11-33 times slower at the b32 shapes
    (``PERF.md`` §5)."""
    b, n, heads, d = t.shape
    # one copy; with one head the reshape alone is a view in channels_last_3d
    # strides, which would send the conv to cuDNN
    grid = t[:, 1:].permute(0, 2, 3, 1).reshape(b * heads, d, *thw).contiguous()
    y = F.conv3d(grid, conv.weight, None, conv.stride, conv.padding, groups=d)
    y = torch.cat([t[:, :1].transpose(1, 2).reshape(b * heads, 1, d),
                   y.flatten(2).transpose(1, 2)], dim=1)
    return F.layer_norm(y, (d,), norm.weight, norm.bias, norm.eps).view(b, heads, -1, d)


def max_pool_tokens(x: torch.Tensor, thw: Tuple[int, int, int], stride) -> torch.Tensor:
    """The skip's MaxPool3d (kernel ``s + 1`` where the stride ``s > 1``,
    padding kernel // 2) over the tokens of ``x`` [B, N, C], cls passed
    around."""
    b, _, c = x.shape
    kernel = tuple(s + 1 if s > 1 else s for s in stride)
    grid = x[:, 1:].reshape(b, *thw, c).permute(0, 4, 1, 2, 3)
    y = F.max_pool3d(grid, kernel, stride, tuple(k // 2 for k in kernel))
    return torch.cat([x[:, :1], y.permute(0, 2, 3, 4, 1).reshape(b, -1, c)], dim=1)


class Attention(nn.Module):
    """``MultiScaleAttention``: ``qkv``, the pools and their norms, the
    relative-position tables, ``proj``."""

    def __init__(self, shape: BlockShape, kernel: Tuple[int, int, int]):
        super().__init__()
        self.shape = shape
        d = shape.head_dim
        self.scale = d ** -0.5
        size = shape.thw[1]
        rows = 2 * max(size // shape.q_stride[1], size // shape.kv_stride[1]) - 1
        self.rel_pos_h = nn.Parameter(torch.zeros(rows, d), requires_grad=False)
        self.rel_pos_w = nn.Parameter(torch.zeros(rows, d), requires_grad=False)
        self.rel_pos_t = nn.Parameter(torch.zeros(2 * shape.thw[0] - 1, d), requires_grad=False)
        self.qkv = nn.Linear(shape.dim, 3 * shape.dim_out)
        self.proj = nn.Linear(shape.dim_out, shape.dim_out)
        pad = tuple(k // 2 for k in kernel)
        for name, stride in (("q", shape.q_stride), ("k", shape.kv_stride), ("v", shape.kv_stride)):
            setattr(self, f"pool_{name}",
                    nn.Conv3d(d, d, kernel, stride, pad, groups=d, bias=False))
            setattr(self, f"norm_{name}", nn.LayerNorm(d, eps=LN_EPS))
        for axis, name in enumerate("thw"):  # moves with the module; not in its state
            self.register_buffer(f"index_{name}", rel_index(shape.q_thw[axis], shape.kv_thw[axis]),
                                 persistent=False)
        self.fused_calls = 0
        for p in self.parameters():
            p.requires_grad_(False)

    def forward(self, x: torch.Tensor, thw: Tuple[int, int, int]) -> torch.Tensor:
        sh = self.shape
        b, n, _ = x.shape
        qkv = self.qkv(x).view(b, n, 3, sh.heads, sh.head_dim)
        q = pool_tokens(qkv[:, :, 0], self.pool_q, self.norm_q, thw)
        k = pool_tokens(qkv[:, :, 1], self.pool_k, self.norm_k, thw)
        v = pool_tokens(qkv[:, :, 2], self.pool_v, self.norm_v, thw)
        rel = rel_tables(q, sh.q_thw, sh.kv_thw, (self.rel_pos_t, self.rel_pos_h, self.rel_pos_w),
                         (self.index_t, self.index_h, self.index_w))
        if q.is_cuda:  # B8, which refuses what it cannot take (config.py refuses it first)
            o = rel_pos_attention(q, k, v, *rel, self.scale)
            with _COUNT:
                self.fused_calls += 1
        else:
            o = rel_pos_attention_plain(q, k, v, *rel, self.scale)
        return self.proj(o)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """``MultiScaleBlock`` (``DIM_MUL_IN_ATT``)."""

    def __init__(self, shape: BlockShape, spec: MViTSpec):
        super().__init__()
        self.shape = shape
        self.norm1 = nn.LayerNorm(shape.dim, eps=LN_EPS)
        self.attn = Attention(shape, spec.pool_kernel)
        self.norm2 = nn.LayerNorm(shape.dim_out, eps=LN_EPS)
        self.mlp = Mlp(shape.dim_out, int(shape.dim_out * spec.mlp_ratio))
        self.proj = nn.Linear(shape.dim, shape.dim_out) if shape.dim != shape.dim_out else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sh = self.shape
        xn = self.norm1(x)
        out = self.attn(xn, sh.thw)
        skip = x if self.proj is None else self.proj(xn)
        if max(sh.q_stride) > 1:
            skip = max_pool_tokens(skip, sh.thw, sh.q_stride)
        x = out.add_(skip)
        return self.mlp(self.norm2(x)).add_(x)


class PatchEmbed(nn.Module):
    def __init__(self, spec: MViTSpec):
        super().__init__()
        self.proj = nn.Conv3d(3, spec.embed_dim, spec.patch_kernel, spec.patch_stride,
                              spec.patch_padding)


class Head(nn.Module):
    def __init__(self, dim: int, classes: int):
        super().__init__()
        self.projection = nn.Linear(dim, classes)


class MViT(nn.Module):
    def __init__(self, spec: MViTSpec = MViTSpec()):
        super().__init__()
        self.spec = spec
        shapes = spec.blocks()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, spec.embed_dim))
        self.patch_embed = PatchEmbed(spec)
        self.blocks = nn.ModuleList(Block(s, spec) for s in shapes)
        self.norm = nn.LayerNorm(shapes[-1].dim_out, eps=LN_EPS)
        self.head = Head(shapes[-1].dim_out, spec.num_classes)
        for p in self.parameters():
            p.requires_grad_(False)

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        """clips: [N, T, H, W, 3] -> logits [N, classes] in fp32."""
        x = self.patch_embed.proj(clips.permute(0, 4, 1, 2, 3))
        n = x.shape[0]
        tokens = x.permute(0, 2, 3, 4, 1).reshape(n, -1, x.shape[1])
        x = torch.cat([self.cls_token.to(tokens.dtype).expand(n, -1, -1), tokens], dim=1)
        for blk in self.blocks:
            x = blk(x)
        norm, proj = self.norm, self.head.projection
        cls = F.layer_norm(x[:, 0].float(), (x.shape[-1],), norm.weight.float(),
                           norm.bias.float(), norm.eps)
        return F.linear(cls, proj.weight.float(), proj.bias.float())

    def load_tree(self, node: Mapping, path: str) -> None:
        """``node``: the flat ``model_state`` layout (``mvit_params_from_state_dict``)."""
        for name, p in self.named_parameters():
            if name not in node:
                raise KeyError(f"{path}.{name} missing from the params tree")
            load_param(p, node[name], f"{path}.{name}")
        self.patch_embed.proj.weight.data = self.patch_embed.proj.weight.data.contiguous(
            memory_format=torch.channels_last_3d)

    def to_tree(self) -> Dict[str, np.ndarray]:
        return {name: to_numpy(p) for name, p in self.named_parameters()}


def fused_attentions(model: nn.Module) -> int:
    """The blocks' attentions of ``model`` that ran on B8 so far."""
    return sum(m.fused_calls for m in model.modules() if isinstance(m, Attention))
