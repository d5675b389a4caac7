"""SlowFast R50 (Feichtenhofer et al., "SlowFast Networks for Video
Recognition", ICCV 2019) as PySlowFast builds it for
``configs/Kinetics/SLOWFAST_8x8_R50.yaml``, BN folded.

This network has no counterpart in the JAX package (whose ``slow_fast`` is
the small two-pathway toy of ``models/temporal.py``); it is served as
``model_type: slowfast_r50``. It takes ``[N, T, H, W, 3]`` normalised RGB
clips, as the other temporal models do, and returns logits ``[N, classes]``
in fp32.

Two pathways over one clip of T frames:

* fast: every frame, ``width / beta_inv`` channels at the stem, temporal
  kernels ``spec.fast_temporal`` (stem 5, then 3 in the first conv of every
  bottleneck);
* slow: T / alpha frames picked at ``linspace(0, T - 1, T / alpha)``
  truncated (PySlowFast's ``pack_pathway_output``: 0, 4, 8, 13, 17, 22, 26,
  31 of 32), ``width`` channels at the stem, temporal kernels
  ``spec.slow_temporal`` (1 up to res3, 3 in res4 and res5).

Each pathway: a stem conv (1x7x7 or 5x7x7, spatial stride 2) + BN + ReLU
and a 1x3x3 max pool at stride 1x2x2; then res2-res5 of ResNet-50
bottlenecks (``spec.depths``), the spatial stride on the 3x3 conv, a
projection shortcut opening each stage, every block ending in
``relu(bn(conv_c) + shortcut)``. After the stem, res2, res3 and res4 a
time-strided lateral (``fusion_kernel`` x1x1 conv at stride (alpha, 1, 1),
BN, ReLU: fast channels x ``fusion_ratio``) is concatenated onto the slow
pathway. The head averages each pathway globally (PySlowFast's head pool
covers the whole final map at the configured crop), concatenates, and
applies the 400-way projection; softmax is the engine's.

Module names follow PySlowFast's ``model_state`` keys (``s1.pathway0_stem
.conv``, ``s2.pathway1_res0.branch2.a``, ``s1_fuse.conv_f2s``,
``head.projection``), so ``weights.slowfast_params_from_state_dict`` folds
each conv's BN onto the conv of the same name.

Every conv runs as cuDNN's ``conv3d`` without its bias on
``channels_last_3d`` activations; on the card one B7 pass
(``ops/epilogue.py``, ``act="relu"``) then adds the folded bias, the
bottleneck's shortcut and the ReLU in place. Elsewhere (the CPU, a
gradient) the conv takes its bias and the add and ReLU follow.

The two stems take 3 channels. For a bf16 ``channels_last_3d`` conv3d of 3
channels (or of 3 padded to 4 or 8) cuDNN has no good plan: the slow stem
(1x7x7) falls to an fp32 NCHW CUDA-core conv between two layout
conversions, and the fast stem (5x7x7 to 8 channels) to a tensor-core
kernel whose 8 output channels fill a quarter of its tile. So on the card
a conv whose input channels are not a multiple of 8 (bf16 or fp16, no
gradient, temporal stride 1) runs as a 2D conv over stacked frames
(``stack_frames``): a row of the 2D input holds, in its channels, the
frames that ``group`` consecutive output frames read, and the 2D weight
(``FoldedConv3d.stacked_weight``: ``group x cout`` output channels, zero
columns for the frames outside each output frame's taps; made on first use,
not a parameter or a buffer) gives those ``group`` frames at once. The slow
stem is then a 2D conv over its N x 8 frames (group 1), the fast stem one
of 24 channels (8 frames) to 32 (4 output frames): the same sums of the
same bf16 products, accumulated in fp32 and rounded once, on cutlass
tensor-core kernels. ``stacked_convs`` counts those calls.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import SLOWFAST_ALPHA
from ..ops.epilogue import conv_epilogue
from .layers import Dense, fuses_epilogue, load_param, to_numpy


@dataclass(frozen=True)
class SlowFastSpec:
    """The network's sizes; the default is SLOWFAST_8x8_R50 at Kinetics-400.
    ``slow_temporal`` and ``fast_temporal``: temporal kernel of the stem, then
    of the first conv of each bottleneck of res2..res5."""

    depths: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64  # RESNET.WIDTH_PER_GROUP: the slow stem's channels
    beta_inv: int = 8
    alpha: int = SLOWFAST_ALPHA
    fusion_ratio: int = 2  # SLOWFAST.FUSION_CONV_CHANNEL_RATIO
    fusion_kernel: int = 7  # SLOWFAST.FUSION_KERNEL_SZ
    slow_temporal: Tuple[int, ...] = (1, 1, 1, 3, 3)
    fast_temporal: Tuple[int, ...] = (5, 3, 3, 3, 3)
    num_classes: int = 400

    def stage_widths(self, stage: int, pathway: int) -> Tuple[int, int, int]:
        """(in, inner, out) channels of res(stage + 2) in ``pathway`` (0
        slow, 1 fast); the slow input carries the lateral's channels."""
        inner = self.width * 2 ** stage
        out = 4 * inner
        if pathway == 1:
            fast_in = self.width // self.beta_inv if stage == 0 else (
                4 * self.width * 2 ** (stage - 1) // self.beta_inv)
            return fast_in, inner // self.beta_inv, out // self.beta_inv
        slow_in = self.width if stage == 0 else 4 * self.width * 2 ** (stage - 1)
        return slow_in + self.lateral_out(stage), inner, out

    def lateral_out(self, stage: int) -> int:
        """Channels of the lateral that enters res(stage + 2) (stage 0: the
        stem's)."""
        fast = self.width // self.beta_inv if stage == 0 else (
            4 * self.width * 2 ** (stage - 1) // self.beta_inv)
        return fast * self.fusion_ratio

    @property
    def features(self) -> int:
        """The head's input: both pathways' res5 channels."""
        out = 4 * self.width * 2 ** (len(self.depths) - 1)
        return out + out // self.beta_inv


STACK_DTYPES = (torch.bfloat16, torch.float16)
STACK_COLS = 32  # output channels a stacked row fills at least: cuDNN's narrowest tile
_COUNT = threading.Lock()  # guards every FoldedConv3d's ``stacked_calls``


def stack_frames(x: torch.Tensor, kt: int, group: int) -> torch.Tensor:
    """The 2D input of a conv of temporal kernel ``kt`` (stride 1, padding
    kt // 2) over ``x`` [N, C, T, H, W]: [N * T / group, span * C, H, W],
    ``channels_last``, span = kt + group - 1; row (n, g) holds frames
    ``group * g - kt // 2`` and the span - 1 after it (zero outside the
    clip), frame-major. A view where span is 1 and ``x`` is
    ``channels_last_3d``; else the clip padded in time, then the rows
    gathered from it."""
    n, c, t, h, w = x.shape
    span = kt + group - 1
    frames = x.permute(0, 2, 3, 4, 1)  # [N, T, H, W, C]
    if span > 1:
        p = kt // 2
        frames = F.pad(frames, (0, 0, 0, 0, 0, 0, p, p))
        s = frames.stride()
        frames = frames.as_strided((n, t // group, h, w, span, c),
                                   (s[0], group * s[1], s[2], s[3], s[1], s[4]))
    return frames.reshape(n * t // group, h, w, span * c).permute(0, 3, 1, 2)


def unstack_frames(y: torch.Tensor, n: int, group: int) -> torch.Tensor:
    """A stacked 2D conv's output [N * T / group, group * cout, Ho, Wo]
    (``channels_last``) as the 3D conv's [N, cout, T, Ho, Wo],
    ``channels_last_3d``: a view for group 1, else one copy."""
    rows, cols, ho, wo = y.shape
    cout = cols // group
    y = y.permute(0, 2, 3, 1).reshape(n, rows // n, ho, wo, group, cout)
    y = y.permute(0, 1, 4, 2, 3, 5).contiguous().view(n, rows // n * group, ho, wo, cout)
    return y.permute(0, 4, 1, 2, 3)


def slow_indices(t_len: int, alpha: int) -> List[int]:
    """The slow pathway's frames of a clip of ``t_len`` (PySlowFast's
    ``torch.linspace(0, T - 1, T // alpha).long()``)."""
    return torch.linspace(0, t_len - 1, t_len // alpha).long().tolist()


class FoldedConv3d(nn.Module):
    """A conv (OIDHW weight, ``channels_last_3d``) with its BN folded into
    ``weight`` and ``bias``. Params-tree node: {"w": DHWIO, "b": [cout]}.
    On the card an input of misaligned channels runs as a 2D conv over
    stacked frames (``stack_group``); ``stacked_calls`` counts those."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int, int],
                 stride: Tuple[int, int, int] = (1, 1, 1)):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, *kernel), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)
        self.stride = stride
        self.padding = tuple(k // 2 for k in kernel)
        self.stacked_calls = 0
        self._stacked: Optional[Tuple[tuple, torch.Tensor]] = None  # (key, 2D weight)

    def stack_group(self, x: torch.Tensor) -> int:
        """The output frames a row of the stacked 2D conv gives (the
        smallest power of two whose output channels fill ``STACK_COLS``,
        dividing T), or 0 where the conv of ``x`` stays cuDNN's conv3d: on
        the CPU, in fp32, under a gradient, a temporal stride, or input
        channels that are a multiple of 8."""
        if (x.shape[1] % 8 == 0 or x.device.type != "cuda" or x.dtype not in STACK_DTYPES
                or self.stride[0] != 1 or torch.is_grad_enabled()):
            return 0
        group = 1
        while group * self.weight.shape[0] < STACK_COLS and x.shape[2] % (2 * group) == 0:
            group *= 2
        return group

    def stacked_weight(self, group: int) -> torch.Tensor:
        """The stacked 2D conv's weight [group * cout, span * cin, kh, kw]
        (``stack_frames``), ``channels_last``: output frame f's block of
        rows holds tap k of the 3D weight at frame f + k, zeros elsewhere.
        Kept until the weight changes: another tensor, or one written in
        place (an inference tensor keeps no count of that). Made in the graph
        while traced for export."""
        w = self.weight
        if torch.compiler.is_compiling():
            return _stack_weight(w, group)
        key = (group, w.device, w.dtype, w.data_ptr(), None if w.is_inference() else w._version)
        if self._stacked is None or self._stacked[0] != key:
            self._stacked = (key, _stack_weight(w.detach(), group))
        return self._stacked[1]

    def conv(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """cuDNN's conv of ``x`` (and ``bias``): conv3d, or the stacked 2D
        conv where ``stack_group`` gives a group, its bias added after it as
        PyTorch's cuDNN route adds a conv's."""
        group = self.stack_group(x)
        if not group:
            return F.conv3d(x, self.weight, bias, self.stride, self.padding)
        y = F.conv2d(stack_frames(x, self.weight.shape[2], group), self.stacked_weight(group),
                     None, self.stride[1:], self.padding[1:])
        y = unstack_frames(y, x.shape[0], group)
        with _COUNT:
            self.stacked_calls += 1
        return y if bias is None else y.add_(bias.reshape(1, -1, 1, 1, 1))

    def forward(self, x: torch.Tensor, relu: bool = True,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``relu(conv(x) + bias + residual)`` (no ReLU where ``relu`` is
        false, which no residual takes)."""
        w, b = self.weight, self.bias
        if fuses_epilogue(x, w, b, residual):
            return conv_epilogue(self.conv(x), b, "relu" if relu else None, residual)
        y = self.conv(x, b)
        if residual is not None:
            y = residual + y
        return F.relu(y) if relu else y

    def load_tree(self, node: Mapping, path: str) -> None:
        w = np.asarray(node["w"], np.float32).transpose(4, 3, 0, 1, 2)
        load_param(self.weight, w, path)
        load_param(self.bias, node["b"], path)
        self.weight.data = self.weight.data.contiguous(memory_format=torch.channels_last_3d)

    def to_tree(self) -> Dict[str, np.ndarray]:
        return {"w": to_numpy(self.weight).transpose(2, 3, 4, 1, 0).copy(),
                "b": to_numpy(self.bias)}


def _stack_weight(w: torch.Tensor, group: int) -> torch.Tensor:
    cout, cin, kt, kh, kw = w.shape
    out = w.new_zeros(group, cout, kh, kw, kt + group - 1, cin)
    taps = w.permute(0, 3, 4, 2, 1)  # [cout, kh, kw, kt, cin]
    for f in range(group):
        out[f, :, :, :, f:f + kt] = taps
    return out.reshape(group * cout, kh, kw, -1).permute(0, 3, 1, 2)


class Stem(nn.Module):
    """``ResNetBasicStem``: conv + BN + ReLU, then the 1x3x3 max pool."""

    def __init__(self, cin: int, cout: int, kt: int):
        super().__init__()
        self.conv = FoldedConv3d(cin, cout, (kt, 7, 7), (1, 2, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool3d(self.conv(x), (1, 3, 3), (1, 2, 2), (0, 1, 1))


class Stems(nn.Module):
    def __init__(self, spec: SlowFastSpec):
        super().__init__()
        self.pathway0_stem = Stem(3, spec.width, spec.slow_temporal[0])
        self.pathway1_stem = Stem(3, spec.width // spec.beta_inv, spec.fast_temporal[0])


class Fuse(nn.Module):
    """``FuseFastToSlow``: the time-strided lateral, concatenated onto the
    slow pathway."""

    def __init__(self, cin: int, spec: SlowFastSpec):
        super().__init__()
        self.conv_f2s = FoldedConv3d(cin, cin * spec.fusion_ratio,
                                     (spec.fusion_kernel, 1, 1), (spec.alpha, 1, 1))

    def forward(self, slow: torch.Tensor, fast: torch.Tensor) -> torch.Tensor:
        return torch.cat([slow, self.conv_f2s(fast)], dim=1)


class Transform(nn.Module):
    """``BottleneckTransform`` (``branch2``): kt x1x1, 1x3x3 (the stride),
    1x1x1; the last conv's output is added to the shortcut before its ReLU."""

    def __init__(self, cin: int, inner: int, cout: int, kt: int, stride: int):
        super().__init__()
        self.a = FoldedConv3d(cin, inner, (kt, 1, 1))
        self.b = FoldedConv3d(inner, inner, (1, 3, 3), (1, stride, stride))
        self.c = FoldedConv3d(inner, cout, (1, 1, 1))


class Block(nn.Module):
    """``ResBlock``: ``relu(branch2(x) + shortcut)``, the shortcut a
    projection (``branch1``, 1x1x1 at the block's stride) where the shape
    changes."""

    def __init__(self, cin: int, inner: int, cout: int, kt: int, stride: int):
        super().__init__()
        if cin != cout or stride != 1:
            self.branch1 = FoldedConv3d(cin, cout, (1, 1, 1), (1, stride, stride))
        else:
            self.branch1 = None
        self.branch2 = Transform(cin, inner, cout, kt, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.branch1 is None else self.branch1(x, relu=False)
        t = self.branch2
        return t.c(t.b(t.a(x)), residual=shortcut)


class Stage(nn.Module):
    """``ResStage``: the blocks of both pathways, named
    ``pathway{p}_res{i}``."""

    def __init__(self, spec: SlowFastSpec, stage: int):
        super().__init__()
        self.depth = spec.depths[stage]
        stride = 1 if stage == 0 else 2
        for p, kts in enumerate((spec.slow_temporal, spec.fast_temporal)):
            cin, inner, cout = spec.stage_widths(stage, p)
            for i in range(self.depth):
                setattr(self, f"pathway{p}_res{i}",
                        Block(cin if i == 0 else cout, inner, cout, kts[stage + 1],
                              stride if i == 0 else 1))

    def forward(self, slow: torch.Tensor, fast: torch.Tensor):
        for i in range(self.depth):
            slow = getattr(self, f"pathway0_res{i}")(slow)
            fast = getattr(self, f"pathway1_res{i}")(fast)
        return slow, fast


class Head(nn.Module):
    """``ResNetBasicHead`` at the configured crop: each pathway's global
    average (accumulated and kept in fp32), concatenated, projected."""

    def __init__(self, spec: SlowFastSpec):
        super().__init__()
        self.projection = Dense(spec.features, spec.num_classes)

    def forward(self, slow: torch.Tensor, fast: torch.Tensor) -> torch.Tensor:
        pooled = [torch.mean(x, dim=(2, 3, 4), dtype=torch.float32) for x in (slow, fast)]
        return self.projection(torch.cat(pooled, dim=1))


class SlowFastR50(nn.Module):
    def __init__(self, spec: SlowFastSpec = SlowFastSpec()):
        super().__init__()
        self.spec = spec
        self.s1 = Stems(spec)
        for stage in range(len(spec.depths)):  # s1_fuse, s2, s2_fuse, ..., s5
            setattr(self, f"s{stage + 1}_fuse",
                    Fuse(spec.lateral_out(stage) // spec.fusion_ratio, spec))
            setattr(self, f"s{stage + 2}", Stage(spec, stage))
        self.head = Head(spec)
        self._slow_idx: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def slow_frames(self, x: torch.Tensor) -> torch.Tensor:
        """The slow pathway's frames of ``x`` [N, C, T, H, W], in
        ``channels_last_3d``."""
        key = (x.shape[2], x.device)
        idx = self._slow_idx.get(key)
        if idx is None:
            idx = self._slow_idx[key] = torch.tensor(
                slow_indices(x.shape[2], self.spec.alpha), device=x.device)
        return x.permute(0, 2, 3, 4, 1).index_select(1, idx).permute(0, 4, 1, 2, 3)

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        """clips: [N, T, H, W, 3] (T a multiple of alpha) -> logits [N,
        classes] in fp32."""
        x = clips.permute(0, 4, 1, 2, 3).contiguous(memory_format=torch.channels_last_3d)
        slow = self.s1.pathway0_stem(self.slow_frames(x))
        fast = self.s1.pathway1_stem(x)
        for stage in range(len(self.spec.depths)):
            slow = getattr(self, f"s{stage + 1}_fuse")(slow, fast)
            slow, fast = getattr(self, f"s{stage + 2}")(slow, fast)
        return self.head(slow, fast)


def stacked_convs(model: nn.Module) -> int:
    """The calls of ``model``'s folded convs that ran as stacked 2D convs."""
    return sum(m.stacked_calls for m in model.modules() if isinstance(m, FoldedConv3d))


def conv_names(model: SlowFastR50) -> List[str]:
    """Every folded conv's name, in the order a forward runs them per
    pathway (the names are PySlowFast's conv keys without ``.weight``)."""
    return [name for name, m in model.named_modules() if isinstance(m, FoldedConv3d)]
