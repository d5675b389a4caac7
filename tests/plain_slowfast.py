"""Plain fp32 SlowFast R50 8x8: the reference a served SlowFast is held against.

Feichtenhofer et al., "SlowFast Networks for Video Recognition", ICCV 2019
(arXiv:1812.03982), as PySlowFast builds it from
``configs/Kinetics/SLOWFAST_8x8_R50.yaml`` (``video_model_builder.SlowFast``,
``resnet_helper``, ``stem_helper``, ``head_helper``). Plain ``torch`` only:
it imports neither JAX nor the program under test, and its forward runs
with TF32 off for cuDNN and matmuls (``fp32``), so fp32 means fp32 on a
card.

The network is sized from a configuration (``SlowFast(config)``), as
PySlowFast's ``SlowFast._construct_network`` sizes it: ``width_per_group``,
``beta_inv``, ``alpha``, ``fusion_conv_channel_ratio``,
``fusion_kernel_size``, ``depths`` and ``num_classes`` (the keys of the
benchmark's ``configs/slowfast-*.json``), with the temporal kernels of
``_TEMPORAL_KERNEL_BASIS["slowfast"]`` written out (``TEMPORAL_KERNELS``)
and ``RESNET.SPATIAL_STRIDES`` (``SPATIAL_STRIDES``). A PySlowFast
``model_state`` is loaded into it with ``strict=True``, so a key or a
shape that the configuration does not give raises. ``manifest(config)``
lists the layout's keys and shapes; ``flops_per_clip(config)`` counts the
network's work. BatchNorm stays a separate ``nn.BatchNorm3d`` in eval mode
(eps 1e-5), so a program that folds it is tested on the folding too.

* Input: ``[N, T, H, W, 3]`` uint8 BGR clips at the crop size (``logits``):
  RGB, /255, mean 0.45, std 0.225 (PySlowFast's ``DATA.MEAN``/``STD``),
  ``[N, 3, T, H, W]``; the fast pathway takes every frame, the slow one
  ``linspace(0, T - 1, T // alpha).long()`` (``pack_pathway_output``).
* Stems: conv (kt x7x7, kt 1 slow and 5 fast, spatial stride 2, padding
  (kt//2, 3, 3)) + BN + ReLU + MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1));
  ``width_per_group`` channels slow, ``width_per_group // beta_inv`` fast.
* Laterals (``FuseFastToSlow``) after the stem, res2, res3 and res4: conv
  (``fusion_kernel_size`` x1x1, stride (alpha, 1, 1), padding (k//2, 0, 0))
  from the fast pathway's C channels to ``fusion_conv_channel_ratio`` x C,
  + BN + ReLU, concatenated after the slow channels.
* res2-res5 (``ResStage``): slow inner widths ``width_per_group`` x 1, 2,
  4, 8 and outputs 4 times those, fast ones divided by ``beta_inv``; the
  slow input widens by ``beta_inv // fusion_conv_channel_ratio``'s share
  (the lateral's channels). Bottlenecks ``relu(c_bn(c(relu(b_bn(b(relu(
  a_bn(a(x)))))))) + shortcut)``, ``a`` kt x1x1 (padding kt//2), ``b``
  1x3x3 with the stage's spatial stride in its first block
  (``STRIDE_1X1: False``), ``c`` 1x1x1, the shortcut
  ``branch1_bn(branch1(x))`` (1x1x1 at the stride) where the width or the
  stride changes. The pathway pool between res2 and res3 is 1x1x1 for
  SlowFast: none.
* Head (``ResNetBasicHead``): average pool per pathway, concatenation, the
  projection.

Departures from the published evaluation, none of which changes the
network's function:

* one view, the 224x224 crop of ``TRAIN_CROP_SIZE``, in place of the
  30-view protocol (10 clips x 3 crops of 256): at 224 the head's
  (T/alpha, 7, 7) and (T, 7, 7) pools cover the whole final maps, so they
  are global averages, which is what this file computes;
* logits are returned; the softmax PySlowFast applies before averaging
  over the pooled positions (one position here) is left to the caller;
* dropout (``DROPOUT_RATE`` 0.5) is the identity in eval mode and is left out.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

MEAN, STD = 0.45, 0.225
BN_EPS = 1e-5
# _TEMPORAL_KERNEL_BASIS["slowfast"]: (slow, fast) of the stem, then of the
# first conv of every bottleneck of res2, res3, res4, res5
TEMPORAL_KERNELS = ((1, 5), (1, 3), (1, 3), (3, 3), (3, 3))
SPATIAL_STRIDES = (1, 2, 2, 2)  # res2..res5


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


def slow_indices(t_len: int, alpha: int) -> List[int]:
    return torch.linspace(0, t_len - 1, t_len // alpha).long().tolist()


def _conv(cin: int, cout: int, kernel, stride=(1, 1, 1)) -> nn.Conv3d:
    return nn.Conv3d(cin, cout, kernel, stride=stride,
                     padding=tuple(k // 2 for k in kernel), bias=False)


class Stem(nn.Module):
    def __init__(self, cout: int, kt: int):
        super().__init__()
        self.conv = _conv(3, cout, (kt, 7, 7), (1, 2, 2))
        self.bn = nn.BatchNorm3d(cout, eps=BN_EPS)

    def forward(self, x):
        x = F.relu(self.bn(self.conv(x)))
        return F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))


class Fuse(nn.Module):
    def __init__(self, cin: int, ratio: int, kernel: int, alpha: int):
        super().__init__()
        self.conv_f2s = _conv(cin, cin * ratio, (kernel, 1, 1), (alpha, 1, 1))
        self.bn = nn.BatchNorm3d(cin * ratio, eps=BN_EPS)

    def forward(self, slow, fast):
        return torch.cat([slow, F.relu(self.bn(self.conv_f2s(fast)))], dim=1)


class Transform(nn.Module):
    def __init__(self, cin: int, inner: int, cout: int, kt: int, stride: int):
        super().__init__()
        self.a = _conv(cin, inner, (kt, 1, 1))
        self.a_bn = nn.BatchNorm3d(inner, eps=BN_EPS)
        self.b = _conv(inner, inner, (1, 3, 3), (1, stride, stride))
        self.b_bn = nn.BatchNorm3d(inner, eps=BN_EPS)
        self.c = _conv(inner, cout, (1, 1, 1))
        self.c_bn = nn.BatchNorm3d(cout, eps=BN_EPS)

    def forward(self, x):
        x = F.relu(self.a_bn(self.a(x)))
        x = F.relu(self.b_bn(self.b(x)))
        return self.c_bn(self.c(x))


class Block(nn.Module):
    def __init__(self, cin: int, inner: int, cout: int, kt: int, stride: int):
        super().__init__()
        self.has_branch1 = cin != cout or stride != 1
        if self.has_branch1:
            self.branch1 = _conv(cin, cout, (1, 1, 1), (1, stride, stride))
            self.branch1_bn = nn.BatchNorm3d(cout, eps=BN_EPS)
        self.branch2 = Transform(cin, inner, cout, kt, stride)

    def forward(self, x):
        shortcut = self.branch1_bn(self.branch1(x)) if self.has_branch1 else x
        return F.relu(shortcut + self.branch2(x))


class Stage(nn.Module):
    def __init__(self, dim_in, dim_inner, dim_out, kts, depth: int, stride: int):
        super().__init__()
        self.depth = depth
        for p in (0, 1):
            for i in range(depth):
                setattr(self, f"pathway{p}_res{i}",
                        Block(dim_in[p] if i == 0 else dim_out[p], dim_inner[p], dim_out[p],
                              kts[p], stride if i == 0 else 1))

    def forward(self, slow, fast):
        for i in range(self.depth):
            slow = getattr(self, f"pathway0_res{i}")(slow)
            fast = getattr(self, f"pathway1_res{i}")(fast)
        return slow, fast


class Head(nn.Module):
    def __init__(self, features: int, classes: int):
        super().__init__()
        self.projection = nn.Linear(features, classes)

    def forward(self, slow, fast):
        pooled = [x.mean(dim=(2, 3, 4)) for x in (slow, fast)]
        return self.projection(torch.cat(pooled, dim=1))


class SlowFast(nn.Module):
    """The network ``config`` sizes, fp32, in eval mode, on ``device``, with
    ``state_dict`` (a PySlowFast ``model_state``) loaded strictly where one
    is given."""

    def __init__(self, config: Mapping, state_dict: Optional[Mapping] = None, device="cpu"):
        super().__init__()
        width, beta, alpha = config["width_per_group"], config["beta_inv"], config["alpha"]
        ratio, kernel = config["fusion_conv_channel_ratio"], config["fusion_kernel_size"]
        widen = beta // ratio  # the slow input's share that the lateral brings
        self.alpha, self.stages = alpha, len(config["depths"])
        with torch.device(device):
            self.s1 = nn.Module()
            self.s1.pathway0_stem = Stem(width, TEMPORAL_KERNELS[0][0])
            self.s1.pathway1_stem = Stem(width // beta, TEMPORAL_KERNELS[0][1])
            slow, fast = width, width // beta  # channels out of the stems
            for s, depth in enumerate(config["depths"]):
                setattr(self, f"s{s + 1}_fuse", Fuse(fast, ratio, kernel, alpha))
                inner = width * 2 ** s
                dim_out = (4 * inner, 4 * inner // beta)
                setattr(self, f"s{s + 2}", Stage(
                    (slow + slow // widen, fast), (inner, inner // beta), dim_out,
                    TEMPORAL_KERNELS[s + 1], depth, SPATIAL_STRIDES[s]))
                slow, fast = dim_out
            self.head = Head(slow + fast, config["num_classes"])
        if state_dict is not None:
            self.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()},
                                 strict=True)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N, 3, T, H, W] normalised RGB -> logits [N, classes]."""
        idx = torch.tensor(slow_indices(x.shape[2], self.alpha), device=x.device)
        slow = self.s1.pathway0_stem(x.index_select(2, idx))
        fast = self.s1.pathway1_stem(x)
        for s in range(self.stages):
            slow = getattr(self, f"s{s + 1}_fuse")(slow, fast)
            slow, fast = getattr(self, f"s{s + 2}")(slow, fast)
        return self.head(slow, fast)


def manifest(config: Mapping) -> Dict[str, tuple]:
    """Every key and shape of the PySlowFast ``model_state`` of the network
    ``config`` sizes, in its order."""
    model = SlowFast(config, device="meta")
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def preprocess(clips_u8: torch.Tensor) -> torch.Tensor:
    """[N, T, H, W, 3] uint8 BGR -> [N, 3, T, H, W] normalised fp32 RGB."""
    x = clips_u8.to(torch.float32).flip(-1) / 255.0
    return ((x - MEAN) / STD).permute(0, 4, 1, 2, 3).contiguous()


def logits(model: SlowFast, clips_u8: torch.Tensor, block: int = 8) -> torch.Tensor:
    """fp32 logits [N, classes] of uint8 BGR clips [N, T, H, W, 3], ``block``
    clips at a time on the model's device."""
    dev = next(model.parameters()).device
    out = []
    with torch.no_grad(), fp32():
        for lo in range(0, clips_u8.shape[0], block):
            out.append(model(preprocess(clips_u8[lo:lo + block].to(dev))).cpu())
    return torch.cat(out)


def flops_per_clip(config: Mapping) -> float:
    """Two FLOPs per multiply-add of every conv and the projection over one
    clip of the configuration's ``num_frames`` at ``crop_size`` x
    ``crop_size``, from a forward on the meta device."""
    model = SlowFast(config, device="meta")
    macs = [0]

    def count(mod, inp, out):
        if isinstance(mod, nn.Conv3d):
            macs[0] += out.numel() * mod.weight[0].numel()
        else:
            macs[0] += out.numel() * mod.in_features

    for mod in model.modules():
        if isinstance(mod, (nn.Conv3d, nn.Linear)):
            mod.register_forward_hook(count)
    crop = config["crop_size"]
    model(torch.empty(1, 3, config["num_frames"], crop, crop, device="meta"))
    return 2.0 * macs[0]
