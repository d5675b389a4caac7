"""Conv building blocks on NCHW tensors (OIHW weights, BN folded).

Counterpart of ``realtime_analytics_tpu/models/layers.py``. The model keeps
its activations NCHW-logical in ``torch.channels_last`` memory, which is
the JAX package's NHWC layout byte for byte. BatchNorm never exists at
inference time: the checkpoint loader folds it into conv weight and bias.

Numerics: a bf16 input gives a bf16 output (cuDNN accumulates in fp32), as
the JAX package's convs emit their input dtype; fp32 stays fp32 (the engine
turns TF32 off, so an fp32 conv on the card is true fp32).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    groups: int = 1,
    padding: Optional[int] = None,
) -> torch.Tensor:
    """2D conv with torch-style symmetric padding (default k//2 "autopad")."""
    if padding is None:
        padding = w.shape[-1] // 2
    return F.conv2d(x, w, b, stride=stride, padding=padding, groups=groups)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def conv_act(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *,
             stride: int = 1, padding: Optional[int] = None,
             act: bool = True) -> torch.Tensor:
    """YOLO "Conv" block: conv + (folded BN) + SiLU."""
    y = conv2d(x, w, b, stride=stride, padding=padding)
    return silu(y) if act else y


class ConvAct(nn.Module):
    """Conv (OIHW weight) + folded-BN bias + optional SiLU (YOLO "Conv";
    ``act=False`` is a plain conv). JAX params counterpart:
    {"w": HWIO, "b": [cout]}."""

    def __init__(self, cin: int, cout: int, k: int, s: int = 1,
                 p: Optional[int] = None, act: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)
        self.stride, self.padding, self.act = s, p, act

    def forward(self, x: torch.Tensor, weight: Optional[torch.Tensor] = None):
        w = self.weight if weight is None else weight
        return conv_act(x, w, self.bias, stride=self.stride,
                        padding=self.padding, act=self.act)

    def load_tree(self, node: Mapping, path: str) -> None:
        load_param(self.weight, np.asarray(node["w"], np.float32).transpose(3, 2, 0, 1), path)
        load_param(self.bias, node["b"], path)

    def to_tree(self) -> Dict[str, np.ndarray]:
        return {"w": to_numpy(self.weight).transpose(2, 3, 1, 0).copy(),
                "b": to_numpy(self.bias)}


class Dense(nn.Module):
    """``x @ w + b``. JAX params counterpart: {"w": [in, out], "b": [out]}.
    The weights take the input's dtype, as JAX promotes a bf16 weight
    against an fp32 input (the temporal heads run in fp32)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))

    def load_tree(self, node: Mapping, path: str) -> None:
        load_param(self.weight, np.asarray(node["w"], np.float32).T, path)
        load_param(self.bias, node["b"], path)

    def to_tree(self) -> Dict[str, np.ndarray]:
        return {"w": to_numpy(self.weight).T.copy(), "b": to_numpy(self.bias)}


def load_param(param: torch.Tensor, value, path: str) -> None:
    """Copy a numpy value into a parameter in place (keeping its dtype and
    device); the shapes must match exactly."""
    value = np.array(value, dtype=np.float32)  # a writable copy
    if value.shape != tuple(param.shape):
        raise ValueError(
            f"{path}: tree shape {value.shape} does not match the module's "
            f"{tuple(param.shape)}"
        )
    with torch.no_grad():
        param.copy_(torch.from_numpy(value))


def to_numpy(param: torch.Tensor) -> np.ndarray:
    return param.detach().float().cpu().numpy().copy()


def max_pool(x: torch.Tensor, k: int, stride: int = 1) -> torch.Tensor:
    """Max pooling with torch-parity padding: odd kernels pad k//2 (SPPF's
    MaxPool2d(k, padding=k//2)), even kernels pad 0 (MaxPool2d's default)."""
    pad = k // 2 if k % 2 else 0
    return F.max_pool2d(x, kernel_size=k, stride=stride, padding=pad)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (nn.Upsample(scale_factor=2))."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def make_divisible(v: float, divisor: int = 8) -> int:
    """Round channel counts up to a multiple of ``divisor`` (matches the
    channel arithmetic of published YOLO configs)."""
    return int(np.ceil(v / divisor) * divisor)
