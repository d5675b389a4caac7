"""B4: bilinear letterbox / stretch resize of a uint8 BGR batch.

Counterpart of ``realtime_analytics_tpu/ops/pallas_preprocess.py`` (Pallas
``_kernel``, reached from ``pallas_letterbox`` and
``pallas_stretch_resize``). On the card ``letterbox`` and
``stretch_resize`` launch the hand-written kernel of ``csrc/letterbox.cu``:
a block per segment of an output row stages the source bytes its taps touch
in shared memory (16-byte units, a tap of weight 0 not read) and writes the
row in 16-byte stores; where the taps lie far apart it reads them in place
and stores each pixel as computed. Taps and weights come from small per-axis
tables and each segment's byte span from ``letterbox_plan``, all built once
per geometry and kept on the device. The kernel has two instantiations,
``letterbox_instantiation`` says which a call takes: ``vec16`` (source and
output rows whole multiples of 16 bytes, bases aligned) and ``element``
(any width).
``letterbox_plain`` and ``stretch_resize_plain`` are the same function in
plain PyTorch on the same tables, in the same order (row gather, H pass,
column gather, W pass), so the two agree bit for bit; the wrappers take
them only for tensors on the CPU. ``preprocess_batch`` computes the same
resize with ``F.interpolate``'s fp32 weights, which can round a value at
an exact .5 level boundary the other way.

The function: uint8 NHWC BGR ``[N, Hs, Ws, 3]`` -> RGB in [0, 1],
``[N, dst_h, dst_w, 3]``, resized with half-pixel-centre edge-clamped
bilinear (H first, then W, in fp32), rounded half up to uint8 levels as cv2
does, and padded with 114/255 outside the content window.

The registered op ``rva::letterbox`` (``ops/_cuda.py``) takes a geometry's
tables as tensors and its geometry and plan as integers
(``letterbox_operands``: what the engine prepares once), so that an
exported step takes the tables as inputs instead of building them: the
same launch on CUDA tensors, the plain version on CPU ones.
``letterbox`` and ``stretch_resize`` call it inside ``_cuda.through_ops``
(an exported step), with the operands the caller passes.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _cuda
from .preprocess import PAD_VALUE, LetterboxSpec

_TABLES: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
_PREPARED: Dict[Tuple, Tuple] = {}  # a launch's constant arguments, per geometry
_launch = None  # the bound C entry, set at the first launch

SMEM_LIMIT = 227 * 1024  # dynamic shared memory one block can ask for
MAX_SEG_W = 1024         # output pixels of a row that one block takes
DENSE_SRC_BYTES = 16     # source bytes per output pixel up to which a block
#                          stages its span: every 16-byte unit of it then holds
#                          a tap (beyond: it reads the taps in place)


def bilinear_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per output index: the two source taps (edge-clamped) and the weight
    of the second — the geometry of the reference's ``bilinear_matrix``:
    source coordinate (i + 0.5) * src / dst - 0.5. Where both taps clamp to
    one pixel the weight is 0, so the pick is exact."""
    x = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    x0 = np.floor(x)
    w = x - x0
    i0 = np.clip(x0, 0, src - 1).astype(np.int32)
    i1 = np.clip(x0 + 1, 0, src - 1).astype(np.int32)
    w = np.where(i0 == i1, 0.0, w).astype(np.float32)
    return i0, i1, w


def _tables(spec: LetterboxSpec, device: torch.device):
    """(taps int32 [2*new_h + 2*new_w], weights fp32 [new_h + new_w]) on
    ``device``, in csrc/letterbox.cu's order; built once per geometry."""
    key = (spec.src_h, spec.src_w, spec.new_h, spec.new_w, str(device))
    hit = _TABLES.get(key)
    if hit is None:
        y0, y1, wy = bilinear_taps(spec.src_h, spec.new_h)
        x0, x1, wx = bilinear_taps(spec.src_w, spec.new_w)
        taps = torch.from_numpy(np.concatenate([y0, y1, x0, x1])).to(device)
        weights = torch.from_numpy(np.concatenate([wy, wx])).to(device)
        hit = _TABLES[key] = (taps, weights)
    return hit


def _round_up(v: int, unit: int) -> int:
    return -(-v // unit) * unit


class Plan(NamedTuple):
    """How csrc/letterbox.cu cuts one geometry into blocks."""

    kind: str          # the instantiation: "vec16" or "element"
    seg_w: int         # output pixels of a row per block
    spans: np.ndarray  # int32 [segments, 2]: first staged source-row byte, bytes
    span_cap: int      # shared bytes per staged row: the longest span, to 16
    dense: bool        # a block stages its span (else reads its taps in place)
    threads: int
    smem_bytes: int    # two staged rows and the output strip when dense, else 0


def letterbox_instantiation(src_w: int, dst_w: int, out_dtype: torch.dtype,
                            aligned: bool) -> Optional[str]:
    """Which instantiation of the kernel a call takes: ``vec16``,
    ``element``, or None for an output dtype it does not take.
    ``aligned``: the frames' base pointer is a multiple of 16 bytes."""
    if out_dtype not in (torch.bfloat16, torch.float32):
        return None
    row_out = dst_w * 3 * (2 if out_dtype == torch.bfloat16 else 4)
    vec = aligned and (3 * src_w) % 16 == 0 and row_out % 16 == 0
    return "vec16" if vec else "element"


def segment_spans(spec: LetterboxSpec, seg_w: int, unit: int) -> np.ndarray:
    """Per segment of ``seg_w`` output pixels: the byte span of a source
    row that its taps of nonzero weight touch, as (first byte, bytes), both
    in whole ``unit``s; (0, 0) for a segment without content."""
    x0, x1, wx = bilinear_taps(spec.src_w, spec.new_w)
    last = np.where(wx > 0, x1, x0)  # a second tap of weight 0 is not read
    spans = []
    for sx in range(0, spec.dst_w, seg_w):
        lo = max(sx - spec.pad_left, 0)
        hi = min(min(sx + seg_w, spec.dst_w) - spec.pad_left, spec.new_w)
        if lo >= hi:
            spans.append((0, 0))
            continue
        start = int(3 * x0[lo:hi].min()) // unit * unit
        stop = _round_up(int(3 * last[lo:hi].max()) + 3, unit)
        spans.append((start, stop - start))
    return np.array(spans, dtype=np.int32).reshape(-1, 2)


def letterbox_plan(spec: LetterboxSpec, out_dtype: torch.dtype, kind: str) -> Plan:
    """The kernel's plan for a geometry; raises where a segment would not
    fit a block's shared memory."""
    esz = 2 if out_dtype == torch.bfloat16 else 4
    unit = 16 if kind == "vec16" else 1
    dense = 3 * spec.src_w <= DENSE_SRC_BYTES * spec.new_w
    parts = -(-spec.dst_w // MAX_SEG_W)
    seg_w = spec.dst_w if parts == 1 else _round_up(-(-spec.dst_w // parts), 8)
    spans = segment_spans(spec, seg_w, unit)
    span_cap = _round_up(int(spans[:, 1].max()), 16) if dense else 0
    smem = 2 * span_cap + _round_up(seg_w * 3 * esz, 16) if dense else 0
    if smem > SMEM_LIMIT:  # not with the limits above: 1024 pixels x 16 bytes x 2 rows
        raise ValueError(
            f"letterbox: a segment of {seg_w} pixels of {spec.src_w} -> {spec.new_w} "
            f"needs {smem} bytes of shared memory, over the {SMEM_LIMIT} a block has"
        )
    return Plan(kind, seg_w, spans, span_cap, dense, 256 if seg_w > 128 else 128, smem)


def _prepared(spec: LetterboxSpec, out_dtype: torch.dtype, aligned: bool,
              device: torch.device) -> Tuple:
    """What a launch of one geometry passes after the frames, the output
    and N: (tensors kept alive, table pointers, geometry and plan ints).
    Built once per (geometry, output dtype, alignment, device)."""
    key = (spec, out_dtype, aligned, device)
    hit = _PREPARED.get(key)
    if hit is None:
        kind = letterbox_instantiation(spec.src_w, spec.dst_w, out_dtype, aligned)
        if kind is None:
            raise TypeError(f"letterbox: need a bf16 or fp32 output, got {out_dtype}")
        if spec.dst_h > 65535:
            raise ValueError(f"letterbox: {spec.dst_h} rows exceed one launch's grid")
        plan = letterbox_plan(spec, out_dtype, kind)
        taps, weights = _tables(spec, device)
        spans = torch.from_numpy(plan.spans).to(device)
        hit = _PREPARED[key] = (
            (taps, weights, spans),
            (taps.data_ptr(), weights.data_ptr(), spans.data_ptr()),
            (spec.src_h, spec.src_w, spec.dst_h, spec.dst_w, spec.new_h, spec.new_w,
             spec.pad_top, spec.pad_left, plan.seg_w, plan.span_cap, int(plan.dense),
             plan.threads, int(kind == "vec16"), int(out_dtype == torch.bfloat16)),
        )
    return hit


def stretch_spec(src_hw: Tuple[int, int], dst_hw: Tuple[int, int]) -> LetterboxSpec:
    """The zero-pad spec of a non-aspect-preserving resize, as
    ``pallas_stretch_resize`` builds it."""
    return LetterboxSpec(
        src_h=src_hw[0], src_w=src_hw[1], dst_h=dst_hw[0], dst_w=dst_hw[1],
        scale=1.0, new_h=dst_hw[0], new_w=dst_hw[1], pad_top=0, pad_left=0,
    )


def letterbox_plain(frames_u8: torch.Tensor, spec: LetterboxSpec,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version, any device: the kernel's tables and fp32
    arithmetic as tensor ops."""
    taps, weights = _tables(spec, frames_u8.device)
    return _plain_on_tables(frames_u8, taps, weights, spec, out_dtype)


def _plain_on_tables(frames_u8: torch.Tensor, taps: torch.Tensor, weights: torch.Tensor,
                     spec: LetterboxSpec, out_dtype: torch.dtype) -> torch.Tensor:
    nh, nw = spec.new_h, spec.new_w
    y0, y1 = taps[:nh].long(), taps[nh:2 * nh].long()
    x0, x1 = taps[2 * nh:2 * nh + nw].long(), taps[2 * nh + nw:].long()
    wy, wx = weights[:nh].view(1, nh, 1, 1), weights[nh:].view(1, 1, nw, 1)
    rows0 = frames_u8.index_select(1, y0).to(torch.float32)
    rows1 = frames_u8.index_select(1, y1).to(torch.float32)
    h = (1.0 - wy) * rows0 + wy * rows1  # [N, new_h, src_w, 3]
    r = (1.0 - wx) * h.index_select(2, x0) + wx * h.index_select(2, x1)
    r = torch.floor(r + 0.5).clamp_(0.0, 255.0) * (1.0 / 255.0)
    out = torch.full((frames_u8.shape[0], spec.dst_h, spec.dst_w, 3), PAD_VALUE,
                     dtype=torch.float32, device=frames_u8.device) * (1.0 / 255.0)
    out[:, spec.pad_top:spec.pad_top + nh, spec.pad_left:spec.pad_left + nw] = r.flip(-1)
    return out.to(out_dtype)


class LetterboxOperands(NamedTuple):
    """What ``rva::letterbox`` takes of one geometry besides the frames:
    the tables (taps, weights, the plan's segment spans) on the device and
    the 14 integers of ``csrc/letterbox.cu``'s entry (the geometry, the
    plan, the instantiation, the output type), for frames whose base is
    16-byte aligned (a fresh allocation always is)."""

    taps: torch.Tensor
    weights: torch.Tensor
    spans: torch.Tensor
    ints: Tuple[int, ...]


def letterbox_operands(spec: LetterboxSpec, out_dtype: torch.dtype,
                       device: torch.device) -> LetterboxOperands:
    """The op's operands of one geometry (built once per geometry)."""
    (taps, weights, spans), _, ints = _prepared(spec, out_dtype, True, torch.device(device))
    return LetterboxOperands(taps, weights, spans, ints)


def letterbox(frames_u8: torch.Tensor, spec: LetterboxSpec,
              out_dtype: torch.dtype = torch.bfloat16,
              operands: Optional[LetterboxOperands] = None,
              mesh=None) -> torch.Tensor:
    """frames_u8: [N, src_h, src_w, 3] uint8 BGR, contiguous. Returns the
    letterboxed RGB canvas [N, dst_h, dst_w, 3] in ``out_dtype`` (bf16 or
    fp32), NHWC-contiguous. ``operands``: this geometry's
    ``letterbox_operands``, which a traced step must pass (its tables are
    then the step's inputs); a direct call builds and keeps its own.
    ``mesh``: a device mesh whose dp axis splits the batch; the kernel then
    runs once per dp shard (B4', JAX's ``shard_map``'d ``pallas_letterbox``)."""
    if mesh is not None and mesh.shape["dp"] > 1:
        from ..parallel.mesh import dp_map

        return dp_map(lambda f: letterbox(f, spec, out_dtype, operands), mesh, frames_u8)
    if _cuda.routed_through_ops():
        if operands is None:
            raise ValueError("letterbox: a traced step takes the geometry's tables as "
                             "inputs: pass letterbox_operands")
        return torch.ops.rva.letterbox(frames_u8, operands.taps, operands.weights,
                                       operands.spans, list(operands.ints), out_dtype)
    if frames_u8.device.type == "cpu":
        return letterbox_plain(frames_u8, spec, out_dtype)
    dev = _cuda.require_cuda("letterbox", frames_u8)
    _check_frames(frames_u8, spec)
    _, tables, geometry = _prepared(spec, out_dtype, frames_u8.data_ptr() % 16 == 0, dev)
    return _launch_letterbox(frames_u8, tables, geometry, out_dtype)


def _check_frames(frames_u8: torch.Tensor, spec: LetterboxSpec) -> None:
    if frames_u8.dtype != torch.uint8:
        raise TypeError(f"letterbox: need uint8 frames, got {frames_u8.dtype}")
    if frames_u8.dim() != 4 or tuple(frames_u8.shape[1:]) != (spec.src_h, spec.src_w, 3):
        raise ValueError(
            f"letterbox: need frames [N, {spec.src_h}, {spec.src_w}, 3], got "
            f"{tuple(frames_u8.shape)}"
        )
    if not frames_u8.is_contiguous():
        raise ValueError("letterbox: frames must be contiguous")
    if frames_u8.shape[0] > 65535:
        raise ValueError(f"letterbox: {frames_u8.shape[0]} frames exceed one launch's grid")


def _launch_letterbox(frames_u8: torch.Tensor, tables: Tuple[int, int, int],
                      geometry: Tuple[int, ...], out_dtype: torch.dtype) -> torch.Tensor:
    """One launch on checked frames: table pointers and the entry's 14
    integers (the wrapper's and the op's)."""
    global _launch
    dev = frames_u8.device
    out = frames_u8.new_empty((frames_u8.shape[0], geometry[2], geometry[3], 3),
                             dtype=out_dtype)
    if _launch is None:
        _launch = _cuda.entry("rva_letterbox")
    rc = _launch(dev.index, frames_u8.data_ptr(), out.data_ptr(), *tables,
                 frames_u8.shape[0], *geometry, _cuda.stream_of(dev.index))
    if rc:
        _cuda.fail(rc, "letterbox")
    _cuda.LAUNCHES.add("letterbox")
    return out


def _spec_of(ints: List[int]) -> LetterboxSpec:
    src_h, src_w, dst_h, dst_w, new_h, new_w, pad_top, pad_left = ints[:8]
    return LetterboxSpec(src_h=src_h, src_w=src_w, dst_h=dst_h, dst_w=dst_w,
                         scale=new_h / src_h, new_h=new_h, new_w=new_w,
                         pad_top=pad_top, pad_left=pad_left)


@torch.library.custom_op("rva::letterbox", mutates_args=(), device_types="cpu")
def _letterbox_op(frames_u8: torch.Tensor, taps: torch.Tensor, weights: torch.Tensor,
                  spans: torch.Tensor, ints: List[int],
                  out_dtype: torch.dtype) -> torch.Tensor:
    return _plain_on_tables(frames_u8, taps, weights, _spec_of(ints), out_dtype)


@_letterbox_op.register_kernel("cuda")
def _(frames_u8, taps, weights, spans, ints, out_dtype):
    _cuda.require_cuda("letterbox", frames_u8, taps, weights, spans)
    _check_frames(frames_u8, _spec_of(ints))
    if ints[-1] != int(out_dtype == torch.bfloat16):
        raise TypeError(f"letterbox: the operands were made for another output than {out_dtype}")
    if ints[-2] and frames_u8.data_ptr() % 16:
        raise ValueError("letterbox: the operands' vec16 plan needs 16-byte aligned frames")
    return _launch_letterbox(frames_u8, (taps.data_ptr(), weights.data_ptr(),
                                         spans.data_ptr()), tuple(ints), out_dtype)


@_letterbox_op.register_fake
def _(frames_u8, taps, weights, spans, ints, out_dtype):
    return frames_u8.new_empty((frames_u8.shape[0], ints[2], ints[3], 3), dtype=out_dtype)


def stretch_resize_plain(frames_u8: torch.Tensor, dst_hw: Tuple[int, int],
                         out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of ``stretch_resize``, any device."""
    spec = stretch_spec(tuple(frames_u8.shape[1:3]), dst_hw)
    return letterbox_plain(frames_u8, spec, out_dtype)


def stretch_resize(frames_u8: torch.Tensor, dst_hw: Tuple[int, int],
                   out_dtype: torch.dtype = torch.bfloat16,
                   operands: Optional[LetterboxOperands] = None,
                   mesh=None) -> torch.Tensor:
    """Non-aspect-preserving resize to ``dst_hw`` (the ResNet and temporal
    preprocess): the letterbox kernel with a zero-pad spec; once per dp
    shard under ``mesh`` (JAX's ``pallas_stretch_resize`` under a mesh)."""
    spec = stretch_spec(tuple(frames_u8.shape[1:3]), dst_hw)
    return letterbox(frames_u8, spec, out_dtype, operands, mesh)
