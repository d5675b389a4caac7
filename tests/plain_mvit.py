"""Plain fp32 MViTv2-S: the reference a served MViT is held against.

Li et al., "MViTv2: Improved Multiscale Vision Transformers for
Classification and Detection", CVPR 2022 (arXiv:2112.01526), as PySlowFast
builds it from ``configs/Kinetics/MVITv2_S_16x4.yaml``
(``video_model_builder.MViT``, ``attention.MultiScaleBlock``,
``attention.MultiScaleAttention``, ``attention.attention_pool``,
``attention.cal_rel_pos_spatial`` / ``cal_rel_pos_temporal``,
``stem_helper.PatchEmbed``, ``head_helper.TransformerBasicHead``). Plain
``torch`` only: it imports neither JAX nor the program under test, and its
forward runs with TF32 off for cuDNN and matmuls (``fp32``), so fp32 means
fp32 on a card.

The network is sized from a configuration (``MViT(config)``) as
PySlowFast's ``MViT.__init__`` sizes it from the yaml's keys (the
benchmark's ``configs/mvitv2-*.json`` under the same names, lower case):
``depth``, ``embed_dim``, ``num_heads``, ``dim_mul``, ``head_mul``,
``pool_q_stride``, ``pool_kv_stride_adaptive``, ``pool_kvq_kernel``,
``patch_kernel`` / ``patch_stride`` / ``patch_padding``, ``mlp_ratio``,
``num_frames``, ``crop_size`` and ``num_classes`` (``blocks`` derives each
block's widths, heads, strides and token grid). A PySlowFast
``model_state`` is loaded into it with ``strict=True``, so a key or a shape
that the configuration does not give raises. ``manifest(config)`` lists the
layout's keys and shapes; ``flops_per_clip(config)`` counts the network's
work.

* Input: ``[N, T, H, W, 3]`` uint8 BGR clips at the crop size (``logits``):
  RGB, /255, mean 0.45, std 0.225 (PySlowFast's ``DATA.MEAN``/``STD``),
  ``[N, 3, T, H, W]``.
* Patch embedding: Conv3d 3 -> ``embed_dim`` (kernel 3x7x7, stride 2x4x4,
  padding 1x3x3, with bias), flattened to tokens, ``cls_token`` prepended;
  no absolute position embedding (``USE_ABS_POS: False``).
* Block (``MultiScaleBlock``, ``DIM_MUL_IN_ATT``, ``RESIDUAL_POOLING``,
  ``REL_POS_SPATIAL``/``TEMPORAL``; LayerNorm eps 1e-6 everywhere):
  ``xn = norm1(x)``; q, k, v from one ``qkv`` linear (with bias), each pooled
  by its own depthwise Conv3d over the head dim (shared by the heads, no
  bias; stride 1 padding 1 for q outside the stride blocks), the cls token
  passed around the pool, then LayerNormed over the head dim;
  ``attn = (q * scale) @ k^T`` plus, past the cls row and column, the
  decomposed relative positions ``q . Rt[dist_t] + q . Rh[dist_h] + q .
  Rw[dist_w]`` from the unscaled pooled q, materialised as PySlowFast does;
  softmax; ``attn @ v``; ``+ q`` past the cls row; ``proj``. The skip is
  ``proj(xn)`` where the width changes, else ``x``, through a MaxPool3d
  (kernel ``s + 1`` where the q stride ``s > 1``, padding kernel // 2) with
  cls passed around; ``x = skip + attn``, ``x = x + mlp(norm2(x))``, the MLP
  ``fc2(gelu(fc1(.)))`` with exact GELU.
* Head: the final ``norm``, the cls token, ``head.projection``.

Departures from the published evaluation, none of which changes the
network's function:

* one view, the 224x224 crop, in place of the test protocol's 5 clips x 1
  crop;
* logits are returned; the softmax that ``TransformerBasicHead`` applies in
  eval mode is left to the caller;
* dropout and drop-path are the identity in eval mode and are left out.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

MEAN, STD = 0.45, 0.225
LN_EPS = 1e-6


@contextlib.contextmanager
def fp32():
    """TF32 off for cuDNN and matmuls inside the block; the flags are then
    restored."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_width(width, multiplier, min_width=1, divisor=1) -> int:
    """PySlowFast's ``models.utils.round_width``."""
    if not multiplier:
        return width
    width *= multiplier
    min_width = min_width or divisor
    out = max(min_width, int(width + divisor / 2) // divisor * divisor)
    if out < 0.9 * width:
        out += divisor
    return int(out)


def blocks(config: Mapping) -> List[Dict]:
    """Each block's ``dim``, ``dim_out``, ``heads``, ``stride_q`` and
    ``stride_kv`` (empty: no pool), and its input token grid ``thw``, as
    ``MViT.__init__`` derives them."""
    depth = config["depth"]
    dim_mul, head_mul = [1.0] * (depth + 1), [1.0] * (depth + 1)
    for i, m in config["dim_mul"]:
        dim_mul[i] = m
    for i, m in config["head_mul"]:
        head_mul[i] = m
    stride_q: List[Sequence[int]] = [[] for _ in range(depth)]
    for entry in config["pool_q_stride"]:
        stride_q[entry[0]] = list(entry[1:])
    kv = list(config["pool_kv_stride_adaptive"])
    thw = [config["num_frames"] // config["patch_stride"][0],
           config["crop_size"] // config["patch_stride"][1],
           config["crop_size"] // config["patch_stride"][2]]
    dim, heads = config["embed_dim"], config["num_heads"]
    out = []
    for i in range(depth):
        heads = round_width(heads, head_mul[i])
        dim_out = round_width(dim, dim_mul[i], divisor=round_width(heads, head_mul[i]))
        if stride_q[i]:
            kv = [max(kv[d] // stride_q[i][d], 1) for d in range(3)]
        out.append({"dim": dim, "dim_out": dim_out, "heads": heads, "stride_q": stride_q[i],
                    "stride_kv": list(kv), "thw": list(thw)})
        if stride_q[i]:
            thw = [s // q for s, q in zip(thw, stride_q[i])]
        dim = dim_out
    return out


def pooled(thw: Sequence[int], stride: Sequence[int], kernel: Sequence[int]) -> List[int]:
    """The token grid a pool of ``kernel`` at ``stride`` (padding kernel //
    2) leaves of ``thw``; ``thw`` where there is no pool."""
    if not stride:
        return list(thw)
    return [(n + 2 * (k // 2) - k) // s + 1 for n, s, k in zip(thw, stride, kernel)]


def attention_pool(x, pool, thw, norm=None):
    """PySlowFast's ``attention_pool`` on [B, heads, 1 + T*H*W, C]: the cls
    token around ``pool``, then ``norm``. Returns the tensor and its grid."""
    if pool is None:
        return x, list(thw)
    cls, x = x[:, :, :1], x[:, :, 1:]
    b, n, _, c = x.shape
    x = x.reshape(b * n, *thw, c).permute(0, 4, 1, 2, 3).contiguous()
    x = pool(x)
    thw = list(x.shape[2:])
    x = x.reshape(b, n, c, -1).transpose(2, 3)
    x = torch.cat((cls, x), dim=2)
    return (norm(x) if norm is not None else x), thw


def get_rel_pos(rel_pos: torch.Tensor, d: int) -> torch.Tensor:
    """PySlowFast's ``get_rel_pos``: the table, linearly resized to ``d`` rows."""
    if rel_pos.shape[0] == d:
        return rel_pos
    return F.interpolate(rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
                         size=d, mode="linear").reshape(-1, d).permute(1, 0)


def rel_dist(q_n: int, k_n: int) -> torch.Tensor:
    """[q_n, k_n] table rows: ``i * max(k/q, 1) - j * max(q/k, 1) + (k - 1) *
    max(q/k, 1)``."""
    q_ratio, k_ratio = max(k_n / q_n, 1.0), max(q_n / k_n, 1.0)
    dist = torch.arange(q_n)[:, None] * q_ratio - torch.arange(k_n)[None, :] * k_ratio
    return (dist + (k_n - 1) * k_ratio).long()


def cal_rel_pos_spatial(attn, q, q_shape, k_shape, rel_pos_h, rel_pos_w):
    q_t, q_h, q_w = q_shape
    k_t, k_h, k_w = k_shape
    rh = get_rel_pos(rel_pos_h, 2 * max(q_h, k_h) - 1)[rel_dist(q_h, k_h).to(q.device)]
    rw = get_rel_pos(rel_pos_w, 2 * max(q_w, k_w) - 1)[rel_dist(q_w, k_w).to(q.device)]
    b, n, _, dim = q.shape
    r_q = q[:, :, 1:].reshape(b, n, q_t, q_h, q_w, dim)
    rel_h = torch.einsum("bythwc,hkc->bythwk", r_q, rh)
    rel_w = torch.einsum("bythwc,wkc->bythwk", r_q, rw)
    attn[:, :, 1:, 1:] = (
        attn[:, :, 1:, 1:].view(b, -1, q_t, q_h, q_w, k_t, k_h, k_w)
        + rel_h[:, :, :, :, :, None, :, None]
        + rel_w[:, :, :, :, :, None, None, :]
    ).view(b, -1, q_t * q_h * q_w, k_t * k_h * k_w)
    return attn


def cal_rel_pos_temporal(attn, q, q_shape, k_shape, rel_pos_t):
    q_t, q_h, q_w = q_shape
    k_t, k_h, k_w = k_shape
    rt = get_rel_pos(rel_pos_t, 2 * max(q_t, k_t) - 1)[rel_dist(q_t, k_t).to(q.device)]
    b, n, _, dim = q.shape
    r_q = q[:, :, 1:].reshape(b, n, q_t, q_h, q_w, dim)
    r_q = r_q.permute(2, 0, 1, 3, 4, 5).reshape(q_t, b * n * q_h * q_w, dim)
    rel = torch.matmul(r_q, rt.transpose(1, 2)).transpose(0, 1)
    rel = rel.view(b, n, q_h, q_w, q_t, k_t).permute(0, 1, 4, 2, 3, 5)
    attn[:, :, 1:, 1:] = (
        attn[:, :, 1:, 1:].view(b, -1, q_t, q_h, q_w, k_t, k_h, k_w)
        + rel[:, :, :, :, :, :, None, None]
    ).view(b, -1, q_t * q_h * q_w, k_t * k_h * k_w)
    return attn


def _pool(dim: int, kernel, stride) -> Optional[nn.Conv3d]:
    if not stride:
        return None
    return nn.Conv3d(dim, dim, kernel, stride, [k // 2 for k in kernel], groups=dim, bias=False)


class Attention(nn.Module):
    """``MultiScaleAttention`` (mode ``conv``, one ``qkv``)."""

    def __init__(self, blk: Mapping, kernel: Sequence[int]):
        super().__init__()
        dim, dim_out, heads = blk["dim"], blk["dim_out"], blk["heads"]
        self.heads, self.dim_out = heads, dim_out
        head_dim = dim_out // heads
        self.scale = head_dim ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)
        self.pool_q = _pool(head_dim, kernel, blk["stride_q"])
        self.norm_q = nn.LayerNorm(head_dim, eps=LN_EPS) if self.pool_q is not None else None
        self.pool_k = _pool(head_dim, kernel, blk["stride_kv"])
        self.norm_k = nn.LayerNorm(head_dim, eps=LN_EPS) if self.pool_k is not None else None
        self.pool_v = _pool(head_dim, kernel, blk["stride_kv"])
        self.norm_v = nn.LayerNorm(head_dim, eps=LN_EPS) if self.pool_v is not None else None
        size = blk["thw"][1]
        q_size = size // blk["stride_q"][1] if blk["stride_q"] else size
        kv_size = size // blk["stride_kv"][1] if blk["stride_kv"] else size
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * max(q_size, kv_size) - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * max(q_size, kv_size) - 1, head_dim))
        self.rel_pos_t = nn.Parameter(torch.zeros(2 * blk["thw"][0] - 1, head_dim))

    def forward(self, x, thw):
        b, n, _ = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q, q_shape = attention_pool(q, self.pool_q, thw, self.norm_q)
        k, k_shape = attention_pool(k, self.pool_k, thw, self.norm_k)
        v, _ = attention_pool(v, self.pool_v, thw, self.norm_v)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        attn = cal_rel_pos_spatial(attn, q, q_shape, k_shape, self.rel_pos_h, self.rel_pos_w)
        attn = cal_rel_pos_temporal(attn, q, q_shape, k_shape, self.rel_pos_t)
        x = attn.softmax(dim=-1) @ v
        x[:, :, 1:, :] += q[:, :, 1:, :]
        x = x.transpose(1, 2).reshape(b, -1, self.dim_out)
        return self.proj(x), q_shape


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """``MultiScaleBlock`` with ``DIM_MUL_IN_ATT``."""

    def __init__(self, blk: Mapping, kernel: Sequence[int], mlp_ratio: float):
        super().__init__()
        dim, dim_out = blk["dim"], blk["dim_out"]
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(blk, kernel)
        self.norm2 = nn.LayerNorm(dim_out, eps=LN_EPS)
        self.mlp = Mlp(dim_out, int(dim_out * mlp_ratio))
        self.proj = nn.Linear(dim, dim_out) if dim != dim_out else None
        s = blk["stride_q"]
        if s and math.prod(s) > 1:
            k = [q + 1 if q > 1 else q for q in s]
            self.pool_skip = nn.MaxPool3d(k, s, [j // 2 for j in k])
        else:
            self.pool_skip = None

    def forward(self, x, thw):
        xn = self.norm1(x)
        att, thw_new = self.attn(xn, thw)
        if self.proj is not None:
            x = self.proj(xn)
        skip, _ = attention_pool(x.unsqueeze(1), self.pool_skip, thw)
        x = skip.squeeze(1) + att
        return x + self.mlp(self.norm2(x)), thw_new


class Head(nn.Module):
    def __init__(self, dim: int, classes: int):
        super().__init__()
        self.projection = nn.Linear(dim, classes)


class PatchEmbed(nn.Module):
    def __init__(self, config: Mapping):
        super().__init__()
        self.proj = nn.Conv3d(3, config["embed_dim"], config["patch_kernel"],
                              config["patch_stride"], config["patch_padding"])


class MViT(nn.Module):
    """The network ``config`` sizes, fp32, in eval mode, on ``device``, with
    ``state_dict`` (a PySlowFast ``model_state``) loaded strictly where one
    is given."""

    def __init__(self, config: Mapping, state_dict: Optional[Mapping] = None, device="cpu"):
        super().__init__()
        specs = blocks(config)
        kernel = config["pool_kvq_kernel"]
        with torch.device(device):
            self.cls_token = nn.Parameter(torch.zeros(1, 1, config["embed_dim"]))
            self.patch_embed = PatchEmbed(config)
            self.blocks = nn.ModuleList(Block(b, kernel, config["mlp_ratio"]) for b in specs)
            self.norm = nn.LayerNorm(specs[-1]["dim_out"], eps=LN_EPS)
            self.head = Head(specs[-1]["dim_out"], config["num_classes"])
        if state_dict is not None:
            self.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()},
                                 strict=True)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, 3, T, H, W] normalised RGB -> logits [N, classes]."""
        x = self.patch_embed.proj(x)
        thw = list(x.shape[2:])
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat((self.cls_token.expand(x.shape[0], -1, -1), x), dim=1)
        for blk in self.blocks:
            x, thw = blk(x, thw)
        return self.head.projection(self.norm(x)[:, 0])


def manifest(config: Mapping) -> Dict[str, tuple]:
    """Every key and shape of the PySlowFast ``model_state`` of the network
    ``config`` sizes, in its order."""
    model = MViT(config, device="meta")
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def preprocess(clips_u8: torch.Tensor) -> torch.Tensor:
    """[N, T, H, W, 3] uint8 BGR -> [N, 3, T, H, W] normalised fp32 RGB."""
    x = clips_u8.to(torch.float32).flip(-1) / 255.0
    return ((x - MEAN) / STD).permute(0, 4, 1, 2, 3).contiguous()


def logits(model: MViT, clips_u8: torch.Tensor, block: int = 8) -> torch.Tensor:
    """fp32 logits [N, classes] of uint8 BGR clips [N, T, H, W, 3], ``block``
    clips at a time on the model's device."""
    dev = next(model.parameters()).device
    out = []
    with torch.no_grad(), fp32():
        for lo in range(0, clips_u8.shape[0], block):
            out.append(model(preprocess(clips_u8[lo:lo + block].to(dev))).cpu())
    return torch.cat(out)


def token_grids(config: Mapping) -> List[Dict]:
    """Each block's (heads, q grid, k/v grid): the token grids its attention
    sees, cls not counted."""
    kernel = config["pool_kvq_kernel"]
    return [{"heads": b["heads"], "q": pooled(b["thw"], b["stride_q"], kernel),
             "kv": pooled(b["thw"], b["stride_kv"], kernel)} for b in blocks(config)]


def flops_per_clip(config: Mapping) -> float:
    """Two FLOPs per multiply-add over one clip of the configuration's
    ``num_frames`` at ``crop_size`` x ``crop_size``: the patch embedding,
    each block's linears, pools, QK^T and PV, and the relative-position
    products, and the projection (the counts fvcore's tracer makes of
    PySlowFast's forward; normalisations and softmax are not counted)."""
    kernel = config["pool_kvq_kernel"]
    tokens = math.prod(blocks(config)[0]["thw"])
    macs = tokens * config["embed_dim"] * 3 * math.prod(config["patch_kernel"])
    for b, g in zip(blocks(config), token_grids(config)):
        dim, dim_out, heads = b["dim"], b["dim_out"], b["heads"]
        hd = dim_out // heads
        n_in = 1 + math.prod(b["thw"])
        nq, nk = 1 + math.prod(g["q"]), 1 + math.prod(g["kv"])
        macs += n_in * dim * 3 * dim_out  # qkv
        pool = math.prod(kernel) * hd * heads
        macs += pool * ((nq - 1) * bool(b["stride_q"]) + 2 * (nk - 1) * bool(b["stride_kv"]))
        macs += 2 * heads * nq * nk * hd  # QK^T and PV
        macs += heads * (nq - 1) * sum(g["kv"]) * hd  # rel_t, rel_h, rel_w
        macs += nq * dim_out * dim_out  # proj
        if dim != dim_out:
            macs += n_in * dim * dim_out  # the skip's proj
        macs += 2 * nq * dim_out * int(dim_out * config["mlp_ratio"])
    macs += blocks(config)[-1]["dim_out"] * config["num_classes"]
    return 2.0 * macs
