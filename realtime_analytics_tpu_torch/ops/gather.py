"""B1: batched row gather, ``out[n, j, :] = payload[n, idx[n, j], :]``.

Counterpart of ``realtime_analytics_tpu/ops/pallas_gather.py`` (Pallas
``_gather_kernel``). On the card ``row_gather`` launches the hand-written
kernel of ``csrc/gather.cu``: a direct load of each indexed row, bit-exact
by construction. ``row_gather_plain`` is the same function in plain
PyTorch; ``row_gather`` takes it only for tensors on the CPU.

The kernel's device time is a few microseconds; what a caller pays is the
host's cost of launching it. So the wrapper keeps every check that guards
the kernel and nothing else: a bound C function, the raw stream, a
lock-free launch count (``ops/_cuda.py``).

``batched_nms`` makes two calls per step: the top-K boxes ([N, 8400, 4] ->
[N, 512, 4] at 640 input) and the compaction payload ([N, 512, 6] ->
[N, 300, 6]); under a mesh each call launches once per dp shard (B1').

The registered op ``rva::row_gather`` (``ops/_cuda.py``) reaches the same C
entry on a CUDA tensor and the plain version on a CPU one; ``row_gather``
calls it inside ``_cuda.through_ops`` (an exported step).
"""

from __future__ import annotations

import torch

from . import _cuda

_launch = None  # the bound C entry, set at the first launch


def row_gather_plain(payload: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: advanced indexing, any device."""
    rows = torch.arange(payload.shape[0], device=payload.device)[:, None]
    return payload[rows, idx]


def row_gather(payload: torch.Tensor, idx: torch.Tensor, mesh=None) -> torch.Tensor:
    """payload: [N, M, P] float32; idx: [N, K] int64 with 0 <= idx < M (the
    caller's contract — not checked on the card, where it would cost a
    sync). Returns [N, K, P] float32, bit-identical to the payload rows.
    ``mesh``: a device mesh (``parallel/mesh.py``) whose dp axis splits the
    batch; the gather then runs once per dp shard on that shard's rows
    (JAX's ``shard_map``'d form), with the same result."""
    if mesh is not None and mesh.shape["dp"] > 1:
        from ..parallel.mesh import dp_map

        return dp_map(row_gather, mesh, payload, idx)
    if _cuda.routed_through_ops():
        return torch.ops.rva.row_gather(payload, idx)
    if not payload.is_cuda or idx.get_device() != payload.get_device():
        if payload.device.type == "cpu" and idx.device.type == "cpu":
            return row_gather_plain(payload, idx)
        raise ValueError(
            f"row_gather: tensors must share one CUDA device, got "
            f"{payload.device} and {idx.device}"
        )
    return _row_gather_cuda(payload, idx)


def _row_gather_cuda(payload: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The checks and the launch on CUDA tensors (the wrapper's and the
    op's)."""
    global _launch
    if payload.dtype is not torch.float32 or idx.dtype is not torch.int64:
        raise TypeError(
            f"row_gather: payload must be float32 and idx int64, got "
            f"{payload.dtype} and {idx.dtype}"
        )
    try:
        n, m, p = payload.shape
        rows, k = idx.shape
    except ValueError:  # another rank than [N, M, P] and [N, K]
        n, rows = 0, -1
    if rows != n:
        raise ValueError(
            f"row_gather: need payload [N, M, P] and idx [N, K], got "
            f"{tuple(payload.shape)} and {tuple(idx.shape)}"
        )
    if not (payload.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_gather: payload and idx must be contiguous")
    out = payload.new_empty((n, k, p))
    if _launch is None:
        _launch = _cuda.entry("rva_row_gather")
    dev = payload.get_device()
    rc = _launch(dev, payload.data_ptr(), idx.data_ptr(), out.data_ptr(),
                 n, m, k, p, _cuda.stream_of(dev))
    if rc:
        _cuda.fail(rc, "row_gather")
    _cuda.LAUNCHES.add("row_gather")
    return out


@torch.library.custom_op("rva::row_gather", mutates_args=(), device_types="cpu")
def _row_gather_op(payload: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return row_gather_plain(payload, idx)


@_row_gather_op.register_kernel("cuda")
def _(payload: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if idx.get_device() != payload.get_device():
        raise ValueError(
            f"row_gather: tensors must share one CUDA device, got "
            f"{payload.device} and {idx.device}"
        )
    return _row_gather_cuda(payload, idx)


@_row_gather_op.register_fake
def _(payload: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return payload.new_empty((payload.shape[0], idx.shape[1], payload.shape[2]))
