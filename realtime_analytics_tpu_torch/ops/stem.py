"""B3: fused YOLO stem — nodes 0 + 1 (the P1 and P2 convs) in one kernel.

Counterpart of ``realtime_analytics_tpu/ops/pallas_stem.py`` (Pallas
``_kernel``). On the card ``fused_stem_p1p2`` launches one of the two
hand-written kernels of ``csrc/stem.cu``; each block keeps its P1 tile
(with a one-pixel halo) in shared memory, so P1 never reaches device
memory:

* ``"mma"``: bf16 with ``c0 % 16 == 0``, ``c1 % 8 == 0`` and ``W % 8 == 0``
  (every published v8 width at the serving sizes). Both convs run as
  implicit GEMMs on the tensor cores (``mma.sync``, bf16 operands, fp32
  sums) over packed bf16 operands.
* ``"general"``: fp32, and bf16 at any other width. Exact fp32 products on
  the fp32 cores, with a register tile per thread.

``stem_instantiation`` says which one a call takes: a pure function of
(dtype, c0, c1, W). ``fused_stem_p1p2_plain`` is the same function as two
convs in PyTorch, with P1 rounded to the compute dtype in between;
``fused_stem_p1p2`` takes it only for tensors on the CPU.

All versions compute in fp32 on weights holding the compute-dtype values
(``prepare_stem`` lays them out once, at engine build) and round P1 and P2
once each, as the reference's Pallas kernel does (f32 accumulation, bias
and SiLU in f32 before the cast).

The registered op ``rva::fused_stem_p1p2`` (``ops/_cuda.py``) takes
``StemWeights`` as its tensors (the packed bf16 operands optional): the
same launch on CUDA tensors, the plain version on CPU ones.
``fused_stem_p1p2`` calls it inside ``_cuda.through_ops`` (an exported
step).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda

STEM_TILE = (8, 16)  # P2 tile of csrc/stem.cu: rows (kTH) x columns (kTW)
SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
K0_PAD = 48  # conv0's K in the mma kernel: 16 per ky (csrc/stem.cu kK0)

_launch = None  # the bound C entry, set at the first launch


@dataclass(frozen=True)
class StemWeights:
    """Stem weights laid out for the kernels: HWIO fp32 copies of the
    compute-dtype values (``dtype``), contiguous, on the model's device;
    for bf16 at the mma kernel's widths also its packed bf16 operands."""

    w0: torch.Tensor  # [3, 3, 3, c0]
    b0: torch.Tensor  # [c0]
    w1: torch.Tensor  # [3, 3, c0, c1]
    b1: torch.Tensor  # [c1]
    dtype: torch.dtype
    w0p: Optional[torch.Tensor] = None  # [K0_PAD, c0] bf16 (pack_w0)
    w1p: Optional[torch.Tensor] = None  # [9 * c0, c1] bf16 (pack_w1)

    @property
    def c0(self) -> int:
        return self.w0.shape[-1]

    @property
    def c1(self) -> int:
        return self.w1.shape[-1]


def pack_w0(w0: torch.Tensor) -> torch.Tensor:
    """HWIO [3, 3, 3, c0] -> the mma kernel's conv0 B operand [48, c0] bf16.
    K is one step of 16 per ky: row ``ky * 16 + 1 + kx * 3 + ci`` holds
    ``w0[ky, kx, ci]``; row ``ky * 16`` and rows ``ky * 16 + 10 ..`` are 0
    (the leading 0 aligns the A fragments, see csrc/stem.cu)."""
    c0 = w0.shape[-1]
    packed = torch.zeros((3, K0_PAD // 3, c0), dtype=torch.bfloat16, device=w0.device)
    packed[:, 1:10] = w0.reshape(3, 9, c0).to(torch.bfloat16)
    return packed.reshape(K0_PAD, c0).contiguous()


def pack_w1(w1: torch.Tensor) -> torch.Tensor:
    """HWIO [3, 3, c0, c1] -> conv1's B operand [9 * c0, c1] bf16, row
    ``(ky * 3 + kx) * c0 + ci``: one k-step of 16 is one tap's 16 channels."""
    return w1.reshape(-1, w1.shape[-1]).to(torch.bfloat16).contiguous()


def mma_widths_ok(c0: int, c1: int) -> bool:
    """The widths the mma kernel's fragments tile: k-steps of 16 input
    channels of conv1, output tiles of 8 channels (at most 32 of them: a
    warp copies a row of w1 with one lane per 8 channels)."""
    return c0 % 16 == 0 and c1 % 8 == 0 and c1 <= 256


def prepare_stem(w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
                 b1: torch.Tensor, dtype: torch.dtype) -> StemWeights:
    """OIHW conv weights (+ biases) of nodes 0 and 1 -> ``StemWeights``
    holding their ``dtype``-rounded values."""

    def lay(t, perm=None):
        t = t.detach().to(dtype).to(torch.float32)
        return (t.permute(*perm) if perm else t).contiguous()

    w0h, w1h = lay(w0, (2, 3, 1, 0)), lay(w1, (2, 3, 1, 0))
    packed = dtype == torch.bfloat16 and mma_widths_ok(w0h.shape[-1], w1h.shape[-1])
    return StemWeights(
        w0=w0h, b0=lay(b0), w1=w1h, b1=lay(b1), dtype=dtype,
        w0p=pack_w0(w0h) if packed else None,
        w1p=pack_w1(w1h) if packed else None,
    )


def stem_smem_bytes(c0: int, c1: int, kind: str = "general") -> int:
    """Shared memory one block of csrc/stem.cu needs (mirrors
    ``general_smem_bytes`` and ``mma_plan`` there)."""
    th, tw = STEM_TILE
    if kind == "mma":
        # the patch (rows of 72 bf16 pixels) or, later, the staged outputs;
        # the parity-split P1 tile; conv1's weights, rows padded
        patch = (4 * th + 3) * (4 * tw + 8) * 6
        staged = th * tw * (c1 * 2 + 16)
        p1_tile = (2 * th + 1) * 2 * (tw + 1) * (c0 * 2 + 16)
        w1_row = c1 * 2 + (16 if (c1 // 8) % 2 == 0 else 0)
        return max(patch, staged) + p1_tile + 9 * c0 * w1_row
    # in floats: input patch, both weights and biases (channel rows padded
    # to a multiple of 8), and the parity-split P1 tile: an odd count of
    # floats a pixel, rows padded to 8 mod 16 floats (bank layout)
    c0p, c1p = -(-c0 // 8) * 8, -(-c1 // 8) * 8
    patch = (4 * th + 3) * (4 * tw + 4) * 3  # rows of 68 pixels
    p1_row = 2 * (tw + 1) * (c0 | 1)
    p1_row += (8 - p1_row % 16) % 16
    return 4 * (patch + 27 * c0p + 9 * c0 * c1p + c0p + c1p + (2 * th + 1) * p1_row)


def stem_instantiation(dtype: torch.dtype, c0: int, c1: int, w: int) -> Optional[str]:
    """Which kernel of csrc/stem.cu a call takes: ``"mma"`` for bf16 at
    widths its fragments tile, where 16-byte loads of the input rows are
    aligned (rows of ``W * 3`` bf16: ``W % 8 == 0``) and its shared-memory
    plan fits; else ``"general"`` where that plan fits; else None."""
    if (dtype == torch.bfloat16 and mma_widths_ok(c0, c1) and w % 8 == 0
            and stem_smem_bytes(c0, c1, "mma") <= SMEM_LIMIT):
        return "mma"
    if stem_smem_bytes(c0, c1, "general") <= SMEM_LIMIT:
        return "general"
    return None


def stem_geometry_ok(h: int, w: int, c0: int, c1: int,
                     dtype: torch.dtype = torch.float32) -> bool:
    """The kernel's gate: H and W divisible by 4 (both stride-2 convs then
    halve exactly) and a kernel whose shared-memory plan fits Hopper's
    per-block limit (the general kernel's for fp32; bf16 may take the mma
    kernel's smaller plan). Unlike the reference kernel's gate, no 128-lane
    condition and no c1 == 2*c0: the CUDA kernels need neither."""
    return h % 4 == 0 and w % 4 == 0 and (
        stem_instantiation(dtype, c0, c1, w) is not None)


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
    if _cuda.routed_through_ops():
        return torch.ops.rva.fused_stem_p1p2(x, sw.w0, sw.b0, sw.w1, sw.b1, sw.w0p, sw.w1p)
    if x.device.type == "cpu":
        return fused_stem_p1p2_plain(x, sw)
    return _stem_cuda(x, sw)


def _stem_cuda(x: torch.Tensor, sw: StemWeights) -> torch.Tensor:
    """The checks and the launch on CUDA tensors (the wrapper's and the
    op's)."""
    global _launch
    dev = _cuda.require_cuda("fused_stem_p1p2", x, sw.w0, sw.b0, sw.w1, sw.b1)
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dtype != sw.dtype:
        raise TypeError(
            f"fused_stem_p1p2: x must be bf16 or fp32 and match the prepared "
            f"weights ({sw.dtype}), got {x.dtype}"
        )
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"fused_stem_p1p2: need x [N, H, W, 3], got {tuple(x.shape)}")
    n, h, w, _ = x.shape
    c0, c1 = sw.c0, sw.c1
    if not stem_geometry_ok(h, w, c0, c1, x.dtype):
        raise ValueError(
            f"fused_stem_p1p2: geometry H={h} W={w} c0={c0} c1={c1} "
            "fails the kernel's gate (stem_geometry_ok)"
        )
    if not x.is_contiguous():
        raise ValueError("fused_stem_p1p2: x must be NHWC-contiguous")
    mma = stem_instantiation(x.dtype, c0, c1, w) == "mma"
    if mma:
        if sw.w0p is None or sw.w1p is None or sw.w1p.device != dev:
            raise ValueError("fused_stem_p1p2: the mma kernel needs prepare_stem's "
                             "packed operands on x's device")
        if x.data_ptr() % 16:
            raise ValueError("fused_stem_p1p2: the mma kernel's 16-byte loads need x "
                             "16-byte aligned (clone the view)")
    out = torch.empty((n, h // 4, w // 4, c1), dtype=x.dtype, device=dev)
    if _launch is None:
        _launch = _cuda.entry("rva_fused_stem")
    rc = _launch(
        dev.index, x.data_ptr(), sw.w0.data_ptr(), sw.b0.data_ptr(),
        sw.w1.data_ptr(), sw.b1.data_ptr(),
        sw.w0p.data_ptr() if mma else None, sw.w1p.data_ptr() if mma else None,
        out.data_ptr(), n, h, w, c0, c1, int(x.dtype == torch.bfloat16),
        int(mma), _cuda.stream_of(dev.index),
    )
    if rc:
        _cuda.fail(rc, "fused_stem_p1p2")
    _cuda.LAUNCHES.add("fused_stem")
    return out


def _op_weights(x, w0, b0, w1, b1, w0p, w1p) -> StemWeights:
    """The op's tensors as ``StemWeights`` of x's dtype (``prepare_stem``
    rounded them to it)."""
    return StemWeights(w0=w0, b0=b0, w1=w1, b1=b1, dtype=x.dtype, w0p=w0p, w1p=w1p)


@torch.library.custom_op("rva::fused_stem_p1p2", mutates_args=(), device_types="cpu")
def _stem_op(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
             b1: torch.Tensor, w0p: Optional[torch.Tensor],
             w1p: Optional[torch.Tensor]) -> torch.Tensor:
    return fused_stem_p1p2_plain(x, _op_weights(x, w0, b0, w1, b1, w0p, w1p))


@_stem_op.register_kernel("cuda")
def _(x, w0, b0, w1, b1, w0p, w1p):
    return _stem_cuda(x, _op_weights(x, w0, b0, w1, b1, w0p, w1p))


@_stem_op.register_fake
def _(x, w0, b0, w1, b1, w0p, w1p):
    n, h, w, _ = x.shape
    return x.new_empty((n, h // 4, w // 4, w1.shape[-1]))
