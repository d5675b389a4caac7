"""B3: fused YOLO stem — nodes 0 + 1 (the P1 and P2 convs) in one kernel.

Counterpart of ``realtime_analytics_tpu/ops/pallas_stem.py`` (Pallas
``_kernel``). On the card ``fused_stem_p1p2`` launches the hand-written
kernel of ``csrc/stem.cu``: each block keeps its P1 tile (with a one-pixel
halo) in shared memory, so P1 never reaches device memory.
``fused_stem_p1p2_plain`` is the same function as two convs in PyTorch,
with P1 rounded to the compute dtype in between; ``fused_stem_p1p2`` takes
it only for tensors on the CPU.

Both versions compute in fp32 on weights holding the compute-dtype values
(``prepare_stem`` lays them out once, at engine build) and round P1 and P2
once each, as the reference's Pallas kernel does (f32 accumulation, bias
and SiLU in f32 before the cast).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import _cuda

STEM_TILE = 8  # P2 tile edge of csrc/stem.cu (kT)
SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use


@dataclass(frozen=True)
class StemWeights:
    """Stem weights laid out for the kernel: HWIO fp32 copies of the
    compute-dtype values (``dtype``), contiguous, on the model's device."""

    w0: torch.Tensor  # [3, 3, 3, c0]
    b0: torch.Tensor  # [c0]
    w1: torch.Tensor  # [3, 3, c0, c1]
    b1: torch.Tensor  # [c1]
    dtype: torch.dtype

    @property
    def c0(self) -> int:
        return self.w0.shape[-1]

    @property
    def c1(self) -> int:
        return self.w1.shape[-1]


def prepare_stem(w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
                 b1: torch.Tensor, dtype: torch.dtype) -> StemWeights:
    """OIHW conv weights (+ biases) of nodes 0 and 1 -> ``StemWeights``
    holding their ``dtype``-rounded values."""

    def lay(t, perm=None):
        t = t.detach().to(dtype).to(torch.float32)
        return (t.permute(*perm) if perm else t).contiguous()

    return StemWeights(
        w0=lay(w0, (2, 3, 1, 0)), b0=lay(b0),
        w1=lay(w1, (2, 3, 1, 0)), b1=lay(b1), dtype=dtype,
    )


def stem_smem_bytes(c0: int, c1: int) -> int:
    """Shared memory one block of csrc/stem.cu needs (its plan, in floats:
    input patch, P1 tile, both weights, both biases)."""
    t = STEM_TILE
    return 4 * ((4 * t + 3) ** 2 * 3 + (2 * t + 1) ** 2 * c0 + 27 * c0
                + 9 * c0 * c1 + c0 + c1)


def stem_geometry_ok(h: int, w: int, c0: int, c1: int) -> bool:
    """The kernel's gate: H and W divisible by 4 (both stride-2 convs then
    halve exactly) and the block's shared-memory plan within Hopper's
    per-block limit. Unlike the reference kernel's gate, no 128-lane
    condition and no c1 == 2*c0: the CUDA kernel needs neither."""
    return h % 4 == 0 and w % 4 == 0 and stem_smem_bytes(c0, c1) <= SMEM_LIMIT


def fused_stem_p1p2_plain(x: torch.Tensor, sw: StemWeights) -> torch.Tensor:
    """Plain PyTorch version: x [N, H, W, 3] -> [N, H/4, W/4, c1] (NHWC
    memory), two convs in fp32 with P1 rounded to x's dtype in between."""
    xf = x.permute(0, 3, 1, 2).to(torch.float32)
    w0 = sw.w0.permute(3, 2, 0, 1)
    w1 = sw.w1.permute(3, 2, 0, 1)
    p1 = F.silu(F.conv2d(xf, w0, sw.b0, stride=2, padding=1)).to(x.dtype)
    p2 = F.silu(F.conv2d(p1.to(torch.float32), w1, sw.b1, stride=2, padding=1))
    return p2.to(x.dtype).contiguous(memory_format=torch.channels_last).permute(
        0, 2, 3, 1
    )


def fused_stem_p1p2(x: torch.Tensor, sw: StemWeights) -> torch.Tensor:
    """x: [N, H, W, 3] NHWC (compute dtype, pixel scale when the engine's
    stem-folded weights absorb BGR flip and /255). Returns the node-1
    output [N, H/4, W/4, c1] NHWC-contiguous, which the model views as a
    channels_last NCHW tensor with ``permute(0, 3, 1, 2)``."""
    if x.device.type == "cpu":
        return fused_stem_p1p2_plain(x, sw)
    dev = _cuda.require_cuda("fused_stem_p1p2", x, sw.w0, sw.b0, sw.w1, sw.b1)
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dtype != sw.dtype:
        raise TypeError(
            f"fused_stem_p1p2: x must be bf16 or fp32 and match the prepared "
            f"weights ({sw.dtype}), got {x.dtype}"
        )
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"fused_stem_p1p2: need x [N, H, W, 3], got {tuple(x.shape)}")
    n, h, w, _ = x.shape
    if not stem_geometry_ok(h, w, sw.c0, sw.c1):
        raise ValueError(
            f"fused_stem_p1p2: geometry H={h} W={w} c0={sw.c0} c1={sw.c1} "
            "fails the kernel's gate (stem_geometry_ok)"
        )
    if not x.is_contiguous():
        raise ValueError("fused_stem_p1p2: x must be NHWC-contiguous")
    out = torch.empty((n, h // 4, w // 4, sw.c1), dtype=x.dtype, device=dev)
    rc = _cuda.lib().rva_fused_stem(
        dev.index or 0, x.data_ptr(), sw.w0.data_ptr(), sw.b0.data_ptr(),
        sw.w1.data_ptr(), sw.b1.data_ptr(), out.data_ptr(), n, h, w, sw.c0,
        sw.c1, int(x.dtype == torch.bfloat16), _cuda.stream_of(x),
    )
    _cuda.check(rc, "fused_stem_p1p2")
    _cuda.LAUNCHES.add("fused_stem")
    return out
