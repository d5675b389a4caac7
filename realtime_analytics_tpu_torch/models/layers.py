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

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


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
