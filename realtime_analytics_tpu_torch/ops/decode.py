"""B2: fused YOLOv8 head decode (DFL + class reduce), all levels at once.

Counterpart of ``realtime_analytics_tpu/ops/pallas_decode.py`` (Pallas
``_decode_kernel``). On the card ``decode_v8_levels`` launches the
hand-written kernel of ``csrc/decode.cu`` once for the whole head: four
lanes per anchor, the logits read once in 16-byte units, fp32 math, and the
results written straight into the concatenated outputs (every anchor of
level 0, then level 1, ... per image: ``torch.cat(dim=1)``'s order).
``decode_v8_level`` is its one-level case. ``decode_v8_level_plain`` is the
num/den DFL form of the reference's plain decode (``models/yolo.py:483-505``)
in PyTorch and ``decode_v8_levels_plain`` concatenates it over the levels;
the wrappers take them only for tensors on the CPU.

Inputs are NHWC: ``box_f`` [N, h, w, 64] DFL logits and ``cls_f``
[N, h, w, nc] class logits, bf16 or fp32. The model passes the head's last
1x1 conv output, a ``channels_last`` NCHW tensor, as ``permute(0, 2, 3, 1)``
— which IS [N, h, w, C]-contiguous, so no copy is made. The kernel wrapper
raises on a non-contiguous input rather than copying silently.

The kernel has two instantiations, ``decode_instantiation`` says which a
call takes: ``vec16`` (16-byte loads: ``nc`` a multiple of 8 in bf16 or 4
in fp32, every base pointer 16-byte aligned) and ``element`` (any ``nc``,
any alignment).

The registered op ``rva::decode_v8_levels`` (``ops/_cuda.py``) takes the
levels as two tensor lists and the strides: the same launch on CUDA
tensors, the plain version on CPU ones. ``decode_v8_levels`` calls it inside
``_cuda.through_ops`` (an exported step).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import _cuda

REG_MAX = 16
MAX_LEVELS = 4      # levels one launch takes (csrc/decode.cu kMaxLevels)
LANES = 4           # lanes per anchor: lane s owns box side s
BLOCK_ANCHORS = 64  # anchors per block of 256 threads

Level = Tuple[torch.Tensor, torch.Tensor]  # (box_f, cls_f)
Decoded = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_launch = None  # the bound C entry, set at the first launch
_GEOMETRIES: Dict[Tuple, Tuple] = {}  # the launch table per geometry


class _Levels(ctypes.Structure):
    """csrc/decode.cu's ``RvaDecodeLevels``, field for field. The pointer
    fields stay empty here: a launch hands its pointers over as arguments
    and the C entry fills them into its copy."""

    _fields_ = [
        ("box", ctypes.c_void_p * MAX_LEVELS),
        ("cls", ctypes.c_void_p * MAX_LEVELS),
        ("h", ctypes.c_int32 * MAX_LEVELS),
        ("w", ctypes.c_int32 * MAX_LEVELS),
        ("stride", ctypes.c_float * MAX_LEVELS),
        ("offset", ctypes.c_int32 * MAX_LEVELS),
        ("block0", ctypes.c_int32 * (MAX_LEVELS + 1)),
        ("count", ctypes.c_int32),
        ("anchors", ctypes.c_int32),
        ("n", ctypes.c_int32),
    ]


class LevelTable(NamedTuple):
    """Where each level's work and results lie in one launch."""

    offsets: Tuple[int, ...]  # a level's first anchor within an image
    block0: Tuple[int, ...]   # a level's first block; the last entry: all blocks
    anchors: int              # anchors of one image, all levels


def level_table(n: int, shapes: Sequence[Tuple[int, int]]) -> LevelTable:
    """The launch's level table for ``n`` images and levels of ``shapes``
    (h, w). Each level is padded to whole blocks of ``BLOCK_ANCHORS``
    anchors, so that a block serves one level."""
    offsets, block0, anchors = [], [0], 0
    for h, w in shapes:
        offsets.append(anchors)
        anchors += h * w
        block0.append(block0[-1] + -(-n * h * w // BLOCK_ANCHORS))
    return LevelTable(tuple(offsets), tuple(block0), anchors)


def decode_instantiation(dtype: torch.dtype, nc: int, aligned: bool) -> Optional[str]:
    """Which instantiation of the kernel a call takes: ``vec16``,
    ``element``, or None for a dtype it does not take. ``aligned``: every
    base pointer is a multiple of 16 bytes."""
    if dtype not in (torch.bfloat16, torch.float32):
        return None
    per_load = 8 if dtype == torch.bfloat16 else 4  # values in 16 bytes
    return "vec16" if aligned and nc % per_load == 0 else "element"


def decode_v8_level_plain(
    box_f: torch.Tensor, cls_f: torch.Tensor, *, stride: float
) -> Decoded:
    """Plain PyTorch decode: (boxes [N, h*w, 4] f32 xyxy input-px,
    conf [N, h*w] f32, cls [N, h*w] int32)."""
    n, h, w, _ = box_f.shape
    dev = box_f.device
    xd = box_f.to(torch.float32).reshape(n, h, w, 4, REG_MAX)
    mx = xd.amax(dim=-1, keepdim=True)
    e = torch.exp(xd - mx)
    proj = torch.arange(REG_MAX, dtype=torch.float32, device=dev)
    dist = (e * proj).sum(dim=-1) / e.sum(dim=-1)  # (l, t, r, b)
    ax = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    ay = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(ay, ax, indexing="ij")  # [h, w]
    x1 = (gx - dist[..., 0]) * stride
    y1 = (gy - dist[..., 1]) * stride
    x2 = (gx + dist[..., 2]) * stride
    y2 = (gy + dist[..., 3]) * stride
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(n, h * w, 4)
    # max/argmax on the raw logits (sigmoid is monotonic); argmax returns
    # the first maximal index, like jnp.argmax
    conf = torch.sigmoid(cls_f.amax(dim=-1).to(torch.float32)).reshape(n, h * w)
    cls = cls_f.argmax(dim=-1).to(torch.int32).reshape(n, h * w)
    return boxes, conf, cls


def decode_v8_levels_plain(levels: Sequence[Level], strides: Sequence[float]) -> Decoded:
    """Plain PyTorch decode of a whole head: each level's plain decode,
    concatenated over the anchors (boxes [N, A, 4], conf and cls [N, A])."""
    parts = [decode_v8_level_plain(b, c, stride=float(s))
             for (b, c), s in zip(levels, strides)]
    boxes, conf, cls = (torch.cat(p, dim=1) for p in zip(*parts))
    return boxes, conf, cls


def _geometry(shapes: Tuple, strides: Tuple) -> Tuple[_Levels, int, int, int]:
    """The launch table of a head whose box logits have ``shapes``
    ([N, h, w, 64] each), without the pointers: (table, its address, N,
    anchors). Built and checked once per geometry; read-only afterwards, so
    every thread launches from the one copy."""
    key = (shapes, strides)
    hit = _GEOMETRIES.get(key)
    if hit is None:
        count, n = len(shapes), shapes[0][0]
        if count > MAX_LEVELS or len(strides) != count:
            raise ValueError(
                f"decode_v8_levels: need 1 to {MAX_LEVELS} levels and a stride for "
                f"each, got {count} levels and {len(strides)} strides"
            )
        if any(shape[0] != n for shape in shapes):
            raise ValueError(f"decode_v8_levels: levels differ in N: {shapes}")
        grids = tuple((shape[1], shape[2]) for shape in shapes)
        table, t = level_table(n, grids), _Levels()
        if n * table.anchors >= 2**31:
            raise ValueError("decode_v8_levels: too many anchors for one launch")
        t.h[:count] = [h for h, _ in grids]
        t.w[:count] = [w for _, w in grids]
        t.stride[:count] = [float(s) for s in strides]
        t.offset[:count] = table.offsets
        t.block0[:count + 1] = table.block0
        t.count, t.anchors, t.n = count, table.anchors, n
        hit = _GEOMETRIES[key] = (t, ctypes.addressof(t), n, table.anchors)
    return hit


def decode_v8_levels(levels: Sequence[Level], strides: Sequence[float]) -> Decoded:
    """Decode every level of a v8 head; same contract as the plain
    version. On CUDA tensors: one launch, one allocation per output."""
    if not levels:
        raise ValueError("decode_v8_levels: no level to decode")
    if _cuda.routed_through_ops():
        return torch.ops.rva.decode_v8_levels([b for b, _ in levels], [c for _, c in levels],
                                              [float(s) for s in strides])
    if levels[0][0].device.type == "cpu":
        return decode_v8_levels_plain(levels, strides)
    return _decode_cuda(levels, strides)


def _decode_cuda(levels: Sequence[Level], strides: Sequence[float]) -> Decoded:
    """The checks and the one launch on CUDA tensors (the wrapper's and the
    op's)."""
    global _launch
    box0, cls0 = levels[0]
    dev, dtype, nc = box0.device, box0.dtype, cls0.shape[-1]
    if dev.type != "cuda":
        raise ValueError(f"decode_v8_levels: tensors must be on a CUDA device, got {dev}")
    ptrs, shapes, low_bits = [], [], 0
    for box_f, cls_f in levels:
        bs, cs = box_f.shape, cls_f.shape
        if box_f.dtype != dtype or cls_f.dtype != dtype:
            raise TypeError(
                "decode_v8_levels: every box_f and cls_f must share one dtype, "
                f"got {box_f.dtype} and {cls_f.dtype} beside {dtype}"
            )
        if box_f.device != dev or cls_f.device != dev:
            raise ValueError(
                f"decode_v8_levels: tensors must share one CUDA device, got "
                f"{box_f.device} and {cls_f.device} beside {dev}"
            )
        if len(bs) != 4 or len(cs) != 4 or bs[3] != 4 * REG_MAX or cs[3] != nc or (
            bs[0] != cs[0] or bs[1] != cs[1] or bs[2] != cs[2] or nc < 1
        ):
            raise ValueError(
                "decode_v8_levels: need box_f [N, h, w, 64] and cls_f "
                f"[N, h, w, nc] with one nc, got {tuple(bs)} and {tuple(cs)}"
            )
        if not (box_f.is_contiguous() and cls_f.is_contiguous()):
            raise ValueError(
                "decode_v8_levels: inputs must be [N, h, w, C]-contiguous (a "
                "channels_last conv output viewed with permute(0, 2, 3, 1))"
            )
        pb, pc = box_f.data_ptr(), cls_f.data_ptr()
        low_bits |= pb | pc
        ptrs += (pb, pc)
        shapes.append(bs)
    kind = decode_instantiation(dtype, nc, low_bits % 16 == 0)
    if kind is None:
        raise TypeError(f"decode_v8_levels: logits must be bf16 or fp32, got {dtype}")
    _, table, n, anchors = _geometry(tuple(shapes), tuple(strides))
    ptrs += (None,) * (2 * MAX_LEVELS - len(ptrs))
    boxes = box0.new_empty((n, anchors, 4), dtype=torch.float32)
    conf = box0.new_empty((n, anchors), dtype=torch.float32)
    cls = box0.new_empty((n, anchors), dtype=torch.int32)
    if _launch is None:
        _launch = _cuda.entry("rva_decode_v8_levels")
    rc = _launch(
        dev.index, table, *ptrs, boxes.data_ptr(), conf.data_ptr(), cls.data_ptr(),
        nc, dtype == torch.bfloat16, kind == "vec16", _cuda.stream_of(dev.index),
    )
    if rc:
        _cuda.fail(rc, "decode_v8_levels")
    _cuda.LAUNCHES.add("decode_v8")
    return boxes, conf, cls


def decode_v8_level(box_f: torch.Tensor, cls_f: torch.Tensor, *, stride: float) -> Decoded:
    """Decode one v8 head level; same contract as the plain version: the
    one-level case of ``decode_v8_levels``."""
    return decode_v8_levels([(box_f, cls_f)], [stride])


@torch.library.custom_op("rva::decode_v8_levels", mutates_args=(), device_types="cpu")
def _decode_op(box: List[torch.Tensor], cls: List[torch.Tensor],
               strides: List[float]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return decode_v8_levels_plain(list(zip(box, cls)), strides)


@_decode_op.register_kernel("cuda")
def _(box: List[torch.Tensor], cls: List[torch.Tensor],
      strides: List[float]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if len(box) != len(cls) or not box:
        raise ValueError("decode_v8_levels: need one class level for each box level")
    return _decode_cuda(list(zip(box, cls)), strides)


@_decode_op.register_fake
def _(box, cls, strides):
    n, anchors = box[0].shape[0], sum(b.shape[1] * b.shape[2] for b in box)
    return (box[0].new_empty((n, anchors, 4), dtype=torch.float32),
            box[0].new_empty((n, anchors), dtype=torch.float32),
            box[0].new_empty((n, anchors), dtype=torch.int32))
