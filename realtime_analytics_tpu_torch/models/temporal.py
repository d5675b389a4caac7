"""Temporal action-recognition models: CNN-LSTM, ConvGRU, 3D-CNN, SlowFast.

(``build_temporal`` also builds ``slowfast_r50``, the published SlowFast R50
of ``models/slowfast.py``, and ``mvitv2_s``, the published MViTv2-S of
``models/mvit.py``, which have no JAX counterpart.)

Counterpart of ``realtime_analytics_tpu/models/temporal.py``: the same
widths, parameter names and arithmetic, so a JAX params tree maps onto
these modules key by key (``weights.temporal_params_from_jax``). Every
model takes ``[N, T, H, W, 3]`` normalized RGB clips (the JAX NDHWC
layout) and returns action logits ``[N, num_classes]`` in fp32.

  * 2D convs run on NCHW-logical tensors in ``channels_last`` memory, 3D
    convs on NCDHW in ``channels_last_3d`` (the JAX NHWC / NDHWC bytes);
  * the recurrences (LSTM, ConvGRU) are Python loops over T, as JAX's
    ``lax.scan``; ``temporal_pooling`` (avg | max | last) pools the
    per-step outputs;
  * ConvGRU hoists the x-half of both gate convs out of the loop into one
    [N*T]-batched conv over the ``[x; h]``-layout weights, as the JAX model
    does;
  * 3D convs pad ``k//2`` on every side; 3D max-pools use VALID windows.

No kernel runs here: the clip step's kernel is the preprocess (B4).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvAct, Dense, load_param, max_pool, to_numpy
from .mvit import MViT, MViTSpec
from .slowfast import SlowFastR50, SlowFastSpec


def _conv(cin: int, cout: int, k: int, s: int = 1) -> ConvAct:
    return ConvAct(cin, cout, k, s, act=False)


class Conv3d(nn.Module):
    """3D conv (OIDHW weight) + bias, ``k//2`` symmetric padding. JAX
    params counterpart: {"w": DHWIO, "b": [cout]}."""

    def __init__(self, cin: int, cout: int, k: Tuple[int, int, int]):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, *k), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)
        self.padding = tuple(d // 2 for d in k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, self.weight, self.bias, padding=self.padding)

    def load_tree(self, node: Mapping, path: str) -> None:
        w = np.asarray(node["w"], np.float32).transpose(4, 3, 0, 1, 2)
        load_param(self.weight, w, path)
        load_param(self.bias, node["b"], path)

    def to_tree(self) -> Dict[str, np.ndarray]:
        return {"w": to_numpy(self.weight).transpose(2, 3, 4, 1, 0).copy(),
                "b": to_numpy(self.bias)}


class LSTM(nn.Module):
    """Single-layer LSTM weights in the JAX layout: ``wx [F, 4H]``,
    ``wh [H, 4H]``, one bias ``[4H]``; gates split i, f, g, o."""

    def __init__(self, feat: int, hidden: int):
        super().__init__()
        self.wx = nn.Parameter(torch.zeros(feat, 4 * hidden), requires_grad=False)
        self.wh = nn.Parameter(torch.zeros(hidden, 4 * hidden), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(4 * hidden), requires_grad=False)
        self.hidden = hidden

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """feats [T, N, F] -> hidden states [T, N, H]."""
        n = feats.shape[1]
        h = feats.new_zeros((n, self.hidden))
        c = feats.new_zeros((n, self.hidden))
        hs = []
        for x_t in feats:
            gates = x_t @ self.wx + h @ self.wh + self.b
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return torch.stack(hs)

    def load_tree(self, node: Mapping, path: str) -> None:
        for name in ("wx", "wh", "b"):
            load_param(getattr(self, name), node[name], f"{path}.{name}")

    def to_tree(self) -> Dict[str, np.ndarray]:
        return {name: to_numpy(getattr(self, name)) for name in ("wx", "wh", "b")}


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> NCHW-logical, channels_last memory."""
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _ncdhw(clips: torch.Tensor) -> torch.Tensor:
    """[N, T, H, W, C] -> NCDHW-logical, channels_last_3d memory."""
    return clips.permute(0, 4, 1, 2, 3).contiguous(memory_format=torch.channels_last_3d)


def _pool_steps(outputs: torch.Tensor, pooling: str) -> torch.Tensor:
    """outputs: [T, N, ...] -> [N, ...] per temporal_pooling."""
    if pooling == "avg":
        return outputs.mean(dim=0)
    if pooling == "max":
        return outputs.amax(dim=0)
    return outputs[-1]  # "last"


def _pool3d(x: torch.Tensor, k: Tuple[int, int, int]) -> torch.Tensor:
    return F.max_pool3d(x, kernel_size=k, stride=k)  # VALID windows


class FrameEncoder(nn.Module):
    """[B, H, W, 3] -> [B, out_dim]: conv stack + GAP + ReLU projection."""

    def __init__(self, width: int = 64, out_dim: int = 256):
        super().__init__()
        self.c1 = _conv(3, width, 3, 2)
        self.c2 = _conv(width, width * 2, 3, 2)
        self.c3 = _conv(width * 2, width * 4, 3, 2)
        self.proj = Dense(width * 4, out_dim)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.c1(_nchw(frames)))
        y = max_pool(y, 2, stride=2)
        y = F.relu(self.c2(y))
        y = F.relu(self.c3(y))
        return F.relu(self.proj(y.mean(dim=(2, 3))))


class CNNLSTM(nn.Module):
    def __init__(self, num_classes: int, hidden: int = 256, feat: int = 256,
                 pooling: str = "avg"):
        super().__init__()
        self.encoder = FrameEncoder(out_dim=feat)
        self.lstm = LSTM(feat, hidden)
        self.fc = Dense(hidden, num_classes)
        self.pooling = pooling

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        n, t = clips.shape[:2]
        feats = self.encoder(clips.reshape(n * t, *clips.shape[2:])).reshape(n, t, -1)
        hs = self.lstm(feats.transpose(0, 1))  # [T, N, H]
        return self.fc(_pool_steps(hs, self.pooling).float())


class ConvGRU(nn.Module):
    def __init__(self, num_classes: int, hidden_ch: int = 64, pooling: str = "avg"):
        super().__init__()
        hc = hidden_ch
        self.stem = _conv(3, hc, 3, 2)
        # the gates act on [x ; h] concatenated channels (checkpoint layout)
        self.zr = _conv(2 * hc, 2 * hc, 3)
        self.hcand = _conv(2 * hc, hc, 3)
        self.head = _conv(hc, 2 * hc, 3, 2)
        self.fc = Dense(2 * hc, num_classes)
        self.hidden_ch, self.pooling = hc, pooling

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        n, t = clips.shape[:2]
        hc = self.hidden_ch
        enc = F.relu(self.stem(_nchw(clips.reshape(n * t, *clips.shape[2:]))))
        enc = max_pool(enc, 2, stride=2)
        # conv([x; h], W) = conv(x, W[:, :hc]) + conv(h, W[:, hc:]): the
        # x-half of both gates runs once over all N*T frames, outside the
        # loop; the loop runs the half-width h-convs
        wzr, wcand = self.zr.weight, self.hcand.weight
        zr_x = F.conv2d(enc, wzr[:, :hc], self.zr.bias, padding=1)
        cand_x = F.conv2d(enc, wcand[:, :hc], self.hcand.bias, padding=1)

        def unfold(a):  # [N*T, C, h, w] -> [T, N, C, h, w]
            return a.reshape(n, t, *a.shape[1:]).transpose(0, 1)

        zr_x, cand_x = unfold(zr_x), unfold(cand_x)
        wzr_h = wzr[:, hc:].contiguous(memory_format=torch.channels_last)
        wcand_h = wcand[:, hc:].contiguous(memory_format=torch.channels_last)
        h = enc.new_zeros((n, hc, *zr_x.shape[3:])).contiguous(
            memory_format=torch.channels_last)
        hs = []
        for zr_xt, cand_xt in zip(zr_x, cand_x):
            zr = torch.sigmoid(zr_xt + F.conv2d(h, wzr_h, padding=1))
            z, r = zr.chunk(2, dim=1)
            cand = torch.tanh(cand_xt + F.conv2d(r * h, wcand_h, padding=1))
            h = (1.0 - z) * h + z * cand
            hs.append(h)
        pooled = _pool_steps(torch.stack(hs), self.pooling)  # [N, C, h, w]
        y = F.relu(self.head(pooled))
        return self.fc(y.mean(dim=(2, 3)).float())


class CNN3D(nn.Module):
    def __init__(self, num_classes: int, width: int = 64):
        super().__init__()
        w = width
        self.c1 = Conv3d(3, w, (3, 3, 3))
        self.c2 = Conv3d(w, w * 2, (3, 3, 3))
        self.c3 = Conv3d(w * 2, w * 4, (3, 3, 3))
        self.c4 = Conv3d(w * 4, w * 4, (3, 3, 3))
        self.fc = Dense(w * 4, num_classes)

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        """clips: [N, T, H, W, 3] (time = depth axis)."""
        y = _pool3d(F.relu(self.c1(_ncdhw(clips))), (1, 2, 2))
        y = _pool3d(F.relu(self.c2(y)), (2, 2, 2))
        y = _pool3d(F.relu(self.c3(y)), (2, 2, 2))
        y = F.relu(self.c4(y))
        return self.fc(y.mean(dim=(2, 3, 4)).float())


class Pathway(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c1 = Conv3d(3, width, (1, 3, 3))
        self.c2 = Conv3d(width, width * 2, (3, 3, 3))
        self.c3 = Conv3d(width * 2, width * 4, (3, 3, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _pool3d(F.relu(self.c1(x)), (1, 2, 2))
        y = _pool3d(F.relu(self.c2(y)), (1, 2, 2))
        return F.relu(self.c3(y)).mean(dim=(2, 3, 4))


class SlowFast(nn.Module):
    """Two-pathway 3D CNN; the slow pathway samples every alpha-th frame."""

    def __init__(self, num_classes: int, alpha: int = 4, slow_width: int = 64,
                 fast_width: int = 8):
        super().__init__()
        self.slow = Pathway(slow_width)
        self.fast = Pathway(fast_width)
        self.fc = Dense(slow_width * 4 + fast_width * 4, num_classes)
        self.alpha = alpha

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        x = _ncdhw(clips)
        slow = self.slow(x[:, :, :: self.alpha])
        fast = self.fast(x)
        return self.fc(torch.cat([slow, fast], dim=-1).float())


def build_temporal(model_type: str, num_classes: int, pooling: str = "avg", t_len: int = 16,
                   crop: int = 224) -> nn.Module:
    """The temporal model ``model_type``. ``t_len`` and ``crop``: the clip
    ``mvitv2_s`` sizes its relative-position tables for (the other models
    take any)."""
    if model_type == "cnn_lstm":
        return CNNLSTM(num_classes=num_classes, pooling=pooling)
    if model_type == "conv_gru":
        return ConvGRU(num_classes=num_classes, pooling=pooling)
    if model_type == "3d_cnn":
        return CNN3D(num_classes=num_classes)
    if model_type == "slow_fast":
        return SlowFast(num_classes=num_classes)
    if model_type == "slowfast_r50":
        return SlowFastR50(SlowFastSpec(num_classes=num_classes))
    if model_type == "mvitv2_s":
        return MViT(MViTSpec(num_frames=t_len, crop=crop, num_classes=num_classes))
    raise ValueError(f"unsupported temporal model_type: {model_type}")
