"""ResNet-18/34/50 classifiers as a PyTorch ``nn.Module`` (BN folded).

Counterpart of ``realtime_analytics_tpu/models/resnet.py``: the same
stages, blocks and parameter names, so a JAX params tree maps onto this
module key by key (``weights.resnet_params_from_jax``). ``forward`` takes
the JAX package's NHWC input (ImageNet-normalized RGB) and views it as an
NCHW tensor in ``channels_last`` memory; every conv runs channels_last.

Structure (the reference's ResNet classification path): 7x7/2 stem + ReLU,
3x3/2 max-pool, four stages of basic (18, 34) or bottleneck (50) blocks
with a 1x1 projection where the shape changes, global average pool, fc.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvAct, Dense, max_pool

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# blocks per stage, bottleneck?
_DEPTHS = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
}


def _conv(cin: int, cout: int, k: int, s: int = 1) -> ConvAct:
    return ConvAct(cin, cout, k, s, act=False)


class Block(nn.Module):
    """Basic (conv1 3x3/s, conv2 3x3) or bottleneck (conv1 1x1, conv2
    3x3/s, conv3 1x1) residual block; ``down`` is the 1x1/s projection of
    the identity where the shape changes."""

    def __init__(self, cin: int, width: int, stride: int, bottleneck: bool):
        super().__init__()
        cout = width * (4 if bottleneck else 1)
        if bottleneck:
            self.conv1 = _conv(cin, width, 1)
            self.conv2 = _conv(width, width, 3, stride)
            self.conv3 = _conv(width, cout, 1)
        else:
            self.conv1 = _conv(cin, width, 3, stride)
            self.conv2 = _conv(width, cout, 3)
        self.down = _conv(cin, cout, 1, stride) if stride != 1 or cin != cout else None
        self.bottleneck = bottleneck

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.conv1(y))
        if self.bottleneck:
            h = self.conv3(F.relu(self.conv2(h)))
        else:
            h = self.conv2(h)
        identity = y if self.down is None else self.down(y)
        return F.relu(h + identity)


class ResNetModel(nn.Module):
    def __init__(self, variant: str, num_classes: int, stages: Tuple[int, ...],
                 bottleneck: bool):
        super().__init__()
        self.variant, self.num_classes = variant, num_classes
        self.stages, self.bottleneck = stages, bottleneck
        self.stem = _conv(3, 64, 7, 2)
        cin, width = 64, 64
        layers: List[nn.ModuleList] = []
        for stage_idx, n_blocks in enumerate(stages):
            stride = 1 if stage_idx == 0 else 2
            blocks = nn.ModuleList()
            for b in range(n_blocks):
                blocks.append(Block(cin, width, stride if b == 0 else 1, bottleneck))
                cin = width * (4 if bottleneck else 1)
            layers.append(blocks)
            width *= 2
        self.layers = nn.ModuleList(layers)
        self.fc = Dense(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, H, W, 3] ImageNet-normalized RGB (NHWC) -> logits
        [N, num_classes] in the model's dtype."""
        y = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        y = max_pool(F.relu(self.stem(y)), 3, stride=2)
        for blocks in self.layers:
            for blk in blocks:
                y = blk(y)
        return self.fc(y.mean(dim=(2, 3)))


def build_resnet(variant: str = "resnet50", num_classes: int = 1000) -> ResNetModel:
    if variant not in _DEPTHS:
        raise ValueError(f"unsupported resnet variant: {variant}")
    stages, bottleneck = _DEPTHS[variant]
    return ResNetModel(variant, num_classes, stages, bottleneck)


def variant_from_model_path(path: str) -> str:
    """resnet50 / 34 / 18 by the digits in the path (JAX engine rule),
    resnet50 when none match."""
    path = str(path)
    for depth in ("50", "34", "18"):
        if depth in path:
            return f"resnet{depth}"
    return "resnet50"


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB NHWC -> ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std
