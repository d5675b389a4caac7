"""B1: batched row gather, ``out[n, j, :] = payload[n, idx[n, j], :]``.

Counterpart of ``realtime_analytics_tpu/ops/pallas_gather.py`` (Pallas
``_gather_kernel``). On the card ``row_gather`` launches the hand-written
kernel of ``csrc/gather.cu``: a direct load of each indexed row, bit-exact
by construction. ``row_gather_plain`` is the same function in plain
PyTorch; ``row_gather`` takes it only for tensors on the CPU.

``batched_nms`` makes two calls per step: the top-K boxes ([N, 8400, 4] ->
[N, 512, 4] at 640 input) and the compaction payload ([N, 512, 6] ->
[N, 300, 6]).
"""

from __future__ import annotations

import torch

from . import _cuda


def row_gather_plain(payload: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: advanced indexing, any device."""
    rows = torch.arange(payload.shape[0], device=payload.device)[:, None]
    return payload[rows, idx]


def row_gather(payload: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """payload: [N, M, P] float32; idx: [N, K] int64 with 0 <= idx < M (the
    caller's contract — not checked on the card, where it would cost a
    sync). Returns [N, K, P] float32, bit-identical to the payload rows."""
    if payload.device.type == "cpu" and idx.device.type == "cpu":
        return row_gather_plain(payload, idx)
    dev = _cuda.require_cuda("row_gather", payload, idx)
    if payload.dtype != torch.float32 or idx.dtype != torch.int64:
        raise TypeError(
            f"row_gather: payload must be float32 and idx int64, got "
            f"{payload.dtype} and {idx.dtype}"
        )
    if payload.dim() != 3 or idx.dim() != 2 or idx.shape[0] != payload.shape[0]:
        raise ValueError(
            f"row_gather: need payload [N, M, P] and idx [N, K], got "
            f"{tuple(payload.shape)} and {tuple(idx.shape)}"
        )
    if not (payload.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_gather: payload and idx must be contiguous")
    n, m, p = payload.shape
    k = idx.shape[1]
    out = torch.empty((n, k, p), dtype=torch.float32, device=dev)
    rc = _cuda.lib().rva_row_gather(
        dev.index or 0, payload.data_ptr(), idx.data_ptr(), out.data_ptr(),
        n, m, k, p, _cuda.stream_of(payload),
    )
    _cuda.check(rc, "row_gather")
    _cuda.LAUNCHES.add("row_gather")
    return out
