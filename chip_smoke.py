#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA H100.

Run from the root of a checkout, on a machine with one card:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package. Phases, in order:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. build every kernel from ``realtime_analytics_tpu_torch/csrc`` with nvcc
   for sm_90a (build seconds, ``-Xptxas -v`` lines, and the stem kernels'
   registers, spills and shared memory on a line of their own);
3. each kernel against its plain PyTorch version on the card, at the shapes
   its paths give it (B1 row gather, with its device time from a replayed
   CUDA graph and the host's cost per call, beside ``torch.gather``'s; B2
   head decode: the three levels of the 640 head, N=32, bf16, in one launch
   with tied maxima planted, its device time and host cost beside the same
   head decoded level by level, the same head through unaligned views (the
   element instantiation at the main shape), then fp32, class counts that take the
   element instantiation, ragged levels, an unaligned view, one level, and
   NaN and inf logits, each printed with the instantiation it took; B3
   fused stem: N=32, 640 input, bf16 on the tensor cores at the v8n and v8s
   widths and fp32 on the general kernel, plus two small general-kernel
   cases, each printed with the instantiation it took; B4 letterbox:
   32 x 1080p -> 640 (H select), 32 x 720p -> 640 (H mean2),
   32 x 1520x2688 -> 640 (H fractional), all bf16, 32 x 1080p -> 640 H
   select fp32 (the ONNX graph path's letterbox), 32 x 1080p -> 224x224
   fp32, the ResNet stretch, 64 x 1080p -> 224x224 and -> 112x112 fp32,
   the temporal clip stretches, and a 97x211 source, whose rows take the
   element instantiation, each bit-equal to the plain version; B6 NMS keep
   pass from the boxes: N=32, K=512 class-shifted candidates, IoUs exactly
   at the threshold, a NaN box, all and none valid, a chain, K=1024, K=8400
   on 2 and on 32 images (peak memory), bit-equal to the overlap matrix and
   its sweeps, its two passes timed apart, beside the overlap build and B6
   on the matrix that it replaced; the overlap entry on the same cases), timed with
   CUDA events next to its plain version, the one PyTorch call that computes
   the same function where there is one, and its bound (the larger of bytes
   over 3.35 TB/s and operations over the dtype's dense peak, H100 SXM data
   sheet);
4. the main path: ``TorchYoloEngine`` (YOLOv8n, 640, bf16, bucket 32,
   seeded He-scaled weights) on 32 synthetic 1080p frames through
   ``predict_arrays`` (host pick -> selected step), held against the same
   engine with the kernels off (bf16 model outputs within the repo's bf16
   fidelity bound; bf16 detections with B1 + B2 off and fp32 detections
   with every kernel off, frame by frame); step time, frames/s and peak
   memory; the host calls that wait for the card, the kernels and the
   select + NMS stage of a step (``profile_step.py``) with NMS's keep pass
   as the fixpoint sweeps, as the overlap build and B6 on the matrix, and
   as B6 on the boxes;
5. the YOLO device-resize step: the same engine with ``host_resize: off``
   on 32 synthetic 1280x720 frames (full frames -> B4 letterbox -> forward),
   held against ``pallas_preprocess: off``;
6. native int8: the same YOLOv8n with ``precision: int8`` (weights
   quantised per output channel, activation scales calibrated on the card)
   on the 32 1080p frames: every conv calibrated; the int32 accumulators of
   the int8 conv (im2col + ``torch._int_mm``) equal to a float64 convolution
   of the same int8 operands at the stem (K 27 -> 32) and at a 3x3 conv of
   64 input channels; the launches (B2 once, B1 twice, B3 never: the int8
   stem is not fused); detections against the bf16 engine's by IoU, class
   and score; step time, frames/s and peak memory beside the bf16 step, and
   the int8 conv's time beside cuDNN's bf16 conv at those two shapes;
7. YOLOv5n (640, bf16, bucket 32, seeded weights) on the 32 1080p frames:
   B1 twice and no B2 or B3 (a v5 head, a k6 stem); bf16 model outputs
   against fp32 within the repo's bf16 fidelity bound; step time;
8. tiled inference: YOLOv8n, bf16, ``tiling: true`` with the whole-frame
   pass, on 8 of the 1080p frames (64 tiles of 640x640 in two steps, then
   the whole frames in a third): B1, B2 and B3 launched on every step;
   fp32 detections with every kernel on against every kernel off, frame by
   frame; tiles, steps and ms a frame;
9. ResNet-50 (224, 1000 classes, bucket 32, seeded weights) on 32
   synthetic 1080p frames with ``host_resize: off`` (B4 stretch), bf16 and
   fp32, top-5 against ``pallas_preprocess: off``; one step with
   ``host_resize: on`` beside it;
10. the four temporal families (CNN-LSTM and ConvGRU at 224, 3D-CNN and
    SlowFast at 112; T = 16, 400 classes) on 4 clips of 16 synthetic 1080p
    frames with ``host_resize: off``, top-5 against ``pallas_preprocess:
    off``;
11. generic ONNX-graph serving ("onnx"): the seeded YOLOv8n written by the
    port's ``yolo_to_onnx`` (``images`` [N, 3, 640, 640] -> ``output0``
    [N, 84, 8400], the stock Ultralytics layout) served through
    ``create_detector`` on the 32 1080p frames at fp32: full frames through
    B4 (``select``) once a step, B1 twice, B2 and B3 never; detections held
    against the native fp32 engine on the same tree and against the same
    engine with ``pallas_preprocess: off`` and ``pallas_gather: off``; the
    upload, the device step and the graph's host cost planned and
    unplanned; then ``graph_precision: bf16`` (conf delta and matched
    share against fp32, reported); a static-batch copy (Reshape ``0`` dims
    set to 1) through ``torch.func.vmap`` within 1e-4 of the dynamic graph;
    a ResNet-50 classifier graph written with ``onnx_lite`` from the seeded
    tree (B4 ``stretch``), top-5 equal to ``TorchResNetEngine``'s; and
    ``ConvInteger``, ``MatMulInteger``, ``QLinearConv``, ``QLinearMatMul``,
    ``DequantizeLinear`` on single-node graphs, bit-equal to the numpy
    oracle;
12. serving artifacts ("artifact"): the main path, the device-resize
    step, int8, YOLOv5n, ResNet-50 ``full``, CNN-LSTM ``full`` and the
    YOLOv8n ONNX graph, each exported on the card into a ``.rvae`` and
    served from the file alone through ``create_detector``: results equal
    to the live engine's bit for bit; one replayed step's launches by path
    (``rvae_*``: B1 twice, B2, B3 and B6 once on the main path; B4 once on
    the full-frame steps); export seconds, artifact bytes, startup (load +
    warmup against building the live engine from its checkpoint + warmup)
    and step time against the live engine's;
13. training and evaluation ("train"): one YOLOv8n train step at 640
    (nc 80, the seeded weights, 2 labeled synthetic images), its loss and
    every gradient leaf on the card (TF32 off) against the port on the CPU;
    ``make_train_step`` at 640, batch 16, 30 steps on 16 synthetic
    1280x1280 sources (no kernel launched: B2 and B3 have no backward; the
    last loss below the first; ms a step, host batch apart, images/s, peak
    memory; one more step under ``torch.profiler``: its device time and
    top kernels); the trained weights in a fp32 engine (bucket 16) on 16
    labeled 1080p frames (B1 twice, B2, B3 and B6 once; model outputs and
    detections held against every kernel off, class flips only at tied
    logits; detections against B1 off; map50); the train CLI's integration recipe
    (400 steps at 64², nc 4) with its map50 above a random init's; the
    eval CLI on the full-width checkpoint (32 synthetic 1080p frames);
14. the pipelines: ``AnalyticsPipeline`` with 32 pooled ``synthetic://``
    1080p streams at 25 fps on YOLOv8n for about 15 s, then 8 such streams
    on ResNet-50 with ``host_resize: off`` for about 5 s;
15. the stream-sharding supervisor and the dashboard ("shards"): the same
    32 streams and YOLOv8n written to a YAML config (an ``eventbus`` sink on
    a free local port, no frames in the events) and served by the port's CLI
    as a user runs it, ``python -m
    realtime_analytics_tpu_torch.scripts.run_pipeline --shards K --broker``,
    at K = 2 and K = 4: K pipeline processes that share the card and publish
    to one event bus. Each run waits until every shard logs "Pipeline
    started" (``startup_s``), counts every stream's events on the bus with
    the port's ``EventBusSubscriber`` (15 s at K = 2, 10 s at K = 4), checks
    that ``nvidia-smi`` lists K more contexts on the card than before the
    run (it may not name the shards' pids inside a container), that every
    shard logs ``shard i/K: serving 32/K streams``, and that the supervisor
    exits 0 on SIGTERM; it reports each shard's last ``[batcher]`` stats
    beside the in-process pipeline of phase 14. During the K = 2 window the
    port's ``DashboardServer`` runs in this process on the same bus: the
    first ``/ws`` message is the snapshot, events of all 32 streams follow,
    ``/api/health`` and ``/api/snapshot`` answer (the ``dashboard`` line).
    A short third K = 2 run under ``--torch-profile`` counts the kernels in
    each shard's trace: B1, B2, B3 (``mma``) and both passes of B6 in every
    shard, B4 in none; its launches a step are over the trace's B2 count,
    which is one a step on this path;
16. the ``{"kernels": [...]}`` line, the card line, and last
    ``{"ok": true, "device": {...}}``.

Every path of phases 4-14 runs with the launch counters set to 0 just
before and read just after; each fails unless the kernels it runs were
launched (the YOLO v8 steps: ``decode_v8`` exactly once a step; every YOLO
step: ``nms_keep`` once) and, on the int8, v5, ONNX and artifact paths,
unless the kernels those paths skip were not. A kernel's ``launches`` in
the kernels line is its count on one step of the path its row times (the
main path for B1-B3 and B6, the device-resize step for B4), and
``launches_by_path`` holds each path's own count. Any failure
exits non-zero without the last line; so does a machine with no visible
CUDA card, or a directory without the package.
"""

from __future__ import annotations

import ast
import asyncio
import contextlib
import dataclasses
import json
import os
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

N = 32  # frames per step: the 32-stream main path's bucket
ONNX_CONF = 0.25  # the graph phase's threshold: fp32 near ties stay apart after NMS
HW = 640
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
ROOT = Path(__file__).resolve().parent
CARD = ""  # nvidia-smi's name and power limit: main() sets it, every result line carries it


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_us(fn, launches: int = 100, replays: int = 20) -> float:
    """Device time of one call of ``fn`` in microseconds: a CUDA graph of
    ``launches`` calls, replayed back to back, so that no host cost of
    making the calls is in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * launches) * 1e3


def host_us(fns: dict, calls: int = 1000, rounds: int = 5) -> dict:
    """The host's cost of one call of each function in microseconds:
    unsynchronised calls on the host clock, the queue drained first. The
    functions take turns in every round and each keeps its least round: a
    shared host only ever adds time."""
    best = dict.fromkeys(fns, float("inf"))
    for _ in range(rounds):
        for name, fn in fns.items():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            best[name] = min(best[name], (time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def timed_ms(fn, n: int):
    """Host-clock ms of ``fn`` (which ends in a device->host copy), median
    and min of ``n`` calls."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times)


def bound(nbytes: float, flops: float, dtype: torch.dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def check_gather(gen):
    from realtime_analytics_tpu_torch.ops.gather import row_gather, row_gather_plain

    rows = []
    # batched_nms's two calls: the boxes of v8 (8400 anchors) and of v5
    # (25,200: three a cell), then the survivors' rows
    for m, p, k in ((8400, 4, 512), (25200, 4, 512), (512, 6, 300)):
        payload = torch.randn(N, m, p, generator=gen, device="cuda") * 640.0
        bits = payload.view(torch.int32).view(-1)
        special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), 1e-40, -1e-40],
                               device="cuda").view(torch.int32)
        bits[: special.numel()] = special
        bits[special.numel()] = 0x7FC01234  # a NaN with a payload
        idx = torch.randint(0, m, (N, k), generator=gen, device="cuda")
        idx[:, :3] = torch.tensor([0, 1, m - 1], device="cuda")
        got, want = row_gather(payload, idx), row_gather_plain(payload, idx)
        torch.cuda.synchronize()
        exact = torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert exact, f"B1 not bit-exact at {(N, m, p, k)}"
        ms = cuda_ms(lambda: row_gather(payload, idx), iters=200)
        plain_ms = cuda_ms(lambda: row_gather_plain(payload, idx), iters=200)

        def library(payload=payload, idx=idx, p=p):
            return torch.gather(payload, 1, idx[..., None].expand(-1, -1, p))

        lib_ms = cuda_ms(library, iters=200)
        nbytes = N * k * 8 + 2 * N * k * p * 4  # idx + gathered rows + output
        b_ms, b_by = bound(nbytes, 0.0, torch.float32)
        # the two parts of ms apart: the kernel on the card, the call on the
        # host, also through the registered op (an exported step's route)
        host = host_us(dict(kernel=lambda: row_gather(payload, idx), library=library,
                            op=lambda: torch.ops.rva.row_gather(payload, idx)))
        rows.append(dict(shape=[N, m, p, k], max_abs_err=0.0, bit_exact=exact,
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                         device_us=graph_us(lambda: row_gather(payload, idx)),
                         host_us=host["kernel"], op_host_us=host["op"],
                         library_device_us=graph_us(library),
                         library_host_us=host["library"]))
    log("B1 " + json.dumps(dict(rows=rows, card=CARD)))
    first = rows[0]
    return dict(name="row_gather", route="cuda",
                source="realtime_analytics_tpu_torch/csrc/gather.cu",
                replaces="realtime_analytics_tpu/ops/pallas_gather.py:46",
                max_abs_err=0.0, ms=first["ms"], plain_ms=first["plain_ms"],
                bound_ms=first["bound_ms"], bound_by=first["bound_by"],
                library_ms=first["library_ms"])


def check_decode(gen):
    """B2 against its plain version: the whole head in one launch at the
    main path's shapes with tied maxima planted, then the kernel's other
    instantiation and edge shapes at small sizes."""
    from realtime_analytics_tpu_torch.ops.decode import (
        decode_instantiation,
        decode_v8_level,
        decode_v8_level_plain,
        decode_v8_levels,
        decode_v8_levels_plain,
    )

    def head(n, shapes, nc, dtype):
        return [((torch.randn(n, h, w, 64, generator=gen, device="cuda") * 3).to(dtype),
                 (torch.randn(n, h, w, nc, generator=gen, device="cuda") * 3).to(dtype))
                for h, w in shapes]

    def case(name, levels, strides, want_kind, fn=decode_v8_levels, nan=False):
        """Largest box and conf errors against the plain version; class
        ids equal; the instantiation the call took."""
        dtype, nc = levels[0][0].dtype, levels[0][1].shape[-1]
        kind = decode_instantiation(
            dtype, nc, all(t.data_ptr() % 16 == 0 for lvl in levels for t in lvl))
        assert kind == want_kind, f"B2 {name} took {kind}, not {want_kind}"
        got, want = fn(levels, strides), decode_v8_levels_plain(levels, strides)
        torch.cuda.synchronize()
        assert got[0].shape == want[0].shape and got[2].dtype == torch.int32
        assert torch.equal(got[2], want[2]), f"B2 {name}: class ids differ"
        if nan:  # NaN and inf logits give NaN and inf in the same places
            for g, w in zip(got[:2], want[:2]):
                assert torch.equal(g.isnan(), w.isnan()), f"B2 {name}: NaNs differ"
            got = [t.nan_to_num(0.0, 0.0, 0.0) for t in got[:2]]
            want = [t.nan_to_num(0.0, 0.0, 0.0) for t in want[:2]]
        err_box = (got[0] - want[0]).abs().max().item()
        err_conf = (got[1] - want[1]).abs().max().item()
        log(f"B2 {name} ({kind}) {str(dtype)[6:]} nc={nc} "
            f"{[tuple(b.shape[:3]) for b, _ in levels]}: max |boxes| err {err_box:.3g} px "
            f"(tol 1e-3), max |conf| err {err_conf:.3g} (tol 1e-5), cls exact")
        assert err_box <= 1e-3 and err_conf <= 1e-5, f"B2 {name} disagrees"
        return got, dict(kernel=kind, box_err_px=err_box, conf_err=err_conf)

    bf16, f32 = torch.bfloat16, torch.float32
    strides = (8.0, 16.0, 32.0)
    levels = head(N, [(HW // 8,) * 2, (HW // 16,) * 2, (HW // 32,) * 2], 80, bf16)
    for _, cls in levels:
        cls[:, 0] = 0.0                      # all 80 tied: class 0 must win
        cls[:, 1, :, 10] = 40.0              # two-way tie at the max:
        cls[:, 1, :, 20] = 40.0              # class 10 must win
        cls[:, 2, :, 8] = 40.0               # a tie across two lanes' chunks,
        cls[:, 2, :, 7] = 40.0               # (7 | 8): class 7 must win
        cls[:, 3, :, 79] = 40.0              # a tie inside the last chunk:
        cls[:, 3, :, 74] = 40.0              # class 74 must win
    got, main = case("head", levels, strides, "vec16")
    offset = 0
    for box, _ in levels:  # the planted rows, in the concatenated output
        w = box.shape[2]
        for row, winner in enumerate((0, 10, 7, 74)):
            ids = got[2][:, offset + row * w: offset + (row + 1) * w]
            assert bool((ids == winner).all()), f"B2 tie row {row}: class {winner} must win"
        offset += box.shape[1] * w

    cases = {"head": main}

    def unaligned(t):  # the same values through a view 2 bytes past 16-byte alignment
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view

    # the element instantiation at the main shape: the same head, unaligned
    elem_levels = [(unaligned(b), unaligned(c)) for b, c in levels]
    cases["head_element"] = case("head, element", elem_levels, strides, "element")[1]
    small = [(20, 20), (10, 10), (5, 5)]
    cases["fp32"] = case("fp32", head(4, small, 80, f32), strides, "vec16")[1]
    cases["nc3"] = case("nc=3", head(4, small, 3, bf16), strides, "element")[1]
    cases["nc81_fp32"] = case("nc=81", head(4, small, 81, f32), strides, "element")[1]
    cases["ragged"] = case("ragged", head(3, [(9, 13), (5, 7), (3, 2), (1, 1)], 80, bf16),
                           (8.0, 16.0, 32.0, 64.0), "vec16")[1]
    flat = torch.randn(2 * 6 * 6 * 80 + 1, generator=gen, device="cuda").to(bf16)
    view = [(head(2, [(6, 6)], 80, bf16)[0][0], flat[1:].view(2, 6, 6, 80))]
    cases["unaligned"] = case("unaligned view", view, (8.0,), "element")[1]
    cases["one_level"] = case(
        "decode_v8_level", head(5, [(7, 3)], 80, bf16), (16.0,), "vec16",
        fn=lambda lv, st: decode_v8_level(*lv[0], stride=st[0]))[1]
    extreme = head(2, [(8, 8)], 80, f32)
    box, cls = extreme[0]
    box[0, 0, 0, :16], box[0, 0, 0, 0] = -100.0, 100.0   # a one-hot side
    box[0, 1, 0, 3], box[0, 1, 1, 20] = float("inf"), float("nan")
    box[0, 1, 2, 40:48] = -float("inf")
    cls[0, 2, 0, 50], cls[0, 2, 1, [5, 60]] = float("nan"), float("nan")
    cls[0, 2, 2, 9], cls[0, 2, 3] = float("inf"), -float("inf")
    cases["extreme"] = case("NaN and inf logits", extreme, (8.0,), "vec16", nan=True)[1]

    def run():
        return decode_v8_levels(levels, strides)

    def run_plain():
        return decode_v8_levels_plain(levels, strides)

    def run_by_level():  # the head as three one-level launches and three cats
        parts = [decode_v8_level(b, c, stride=s) for (b, c), s in zip(levels, strides)]
        return [torch.cat(p, dim=1) for p in zip(*parts)]

    def run_op():  # the registered op, as an exported step calls it
        return torch.ops.rva.decode_v8_levels([b for b, _ in levels], [c for _, c in levels],
                                              list(strides))

    ms, plain_ms = cuda_ms(run), cuda_ms(run_plain)
    by_level_ms = cuda_ms(run_by_level)
    element_ms = cuda_ms(lambda: decode_v8_levels(elem_levels, strides))
    host = host_us(dict(kernel=run, by_level=run_by_level, op=run_op))
    anchors = sum(b.shape[1] * b.shape[2] for b, _ in levels) * N
    nbytes = anchors * ((64 + 80) * 2 + (4 + 1 + 1) * 4)
    flops = anchors * 480.0  # 4 x 16-bin max/exp/num/den + 80-way max + box
    b_ms, b_by = bound(nbytes, flops, torch.float32)
    row = dict(name="decode_v8", route="cuda",
               source="realtime_analytics_tpu_torch/csrc/decode.cu",
               replaces="realtime_analytics_tpu/ops/pallas_decode.py:61",
               max_abs_err=max(main["box_err_px"], main["conf_err"]), ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log("B2 " + json.dumps(dict(
        row, anchors=anchors, bytes=nbytes, launches_per_head=1, by_level_ms=by_level_ms,
        element_ms=element_ms,
        element_device_us=graph_us(lambda: decode_v8_levels(elem_levels, strides)),
        device_us=graph_us(run), host_us=host["kernel"], op_host_us=host["op"],
        by_level_host_us=host["by_level"], cases=cases, card=CARD)))
    return row


def device_split_us(fn, names, calls: int = 50) -> dict:
    """Device microseconds a call of ``fn`` spends in each kernel whose
    name contains one of ``names`` (``torch.profiler`` over ``calls``
    calls); None where the trace shows no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for name in names:
                if name in e.name:
                    total[name] += e.time_range.end - e.time_range.start
    return {name: (us / calls if us else None) for name, us in total.items()}


def check_nms_keep(gen):
    """B6 from the boxes (``nms_keep_boxes``) against its plain version
    (the overlap matrix and the fixpoint sweeps): keep bit-equal at the
    main path's shape (N images, K = 512 class-shifted candidates in
    clusters, as a detector's top-K gives them; also with only the first 64
    valid, as at conf 0.25), at IoUs exactly at the
    threshold, with a NaN box, all valid, none valid, on a chain where every
    rank overlaps the one before it (the sweeps' worst case: one more sweep
    a rank), at K = 1024, and at K = 8400 (every anchor of a 640 input) on
    2 images and on N images in chunks (held four images at a time); then
    the overlap entry (``nms_keep``: the pack pass and the same chain)
    against its sweeps. Times: the kernel, its two passes, the plain
    version, the path it replaced (the overlap build and ``nms_keep``)."""
    from realtime_analytics_tpu_torch.ops.nms import (
        nms_keep,
        nms_keep_boxes,
        nms_keep_boxes_plain,
        nms_keep_plain,
        overlap_matrix,
        scratch_chunk,
    )

    thr = 0.45  # the engines' default iou_threshold

    def candidates(n, k, valid_p, objects=12):
        """k boxes an image around ``objects`` objects (centre jitter 6 px,
        size jitter 10%), 80 classes (a tenth off the object's), shifted
        into class bands as batched_nms shifts them."""
        dev = "cuda"
        centre = torch.rand(n, objects, 2, generator=gen, device=dev) * 600 + 20
        size = torch.rand(n, objects, 2, generator=gen, device=dev) * 180 + 12
        obj_cls = torch.randint(0, 80, (n, objects), generator=gen, device=dev)
        which = torch.randint(0, objects, (n, k), generator=gen, device=dev)
        pick = which[..., None].expand(-1, -1, 2)
        c = centre.gather(1, pick) + torch.randn(n, k, 2, generator=gen, device=dev) * 6
        wh = size.gather(1, pick) * (1 + 0.1 * torch.randn(n, k, 2, generator=gen, device=dev))
        boxes = torch.cat([c - wh / 2, c + wh / 2], -1)
        cls = obj_cls.gather(1, which)
        noise = torch.rand(n, k, generator=gen, device=dev) < 0.1
        cls = torch.where(noise, torch.randint(0, 80, (n, k), generator=gen, device=dev), cls)
        lo = boxes.min()
        offset = torch.clamp_min(boxes.max() - lo, 8192.0) + 1.0
        boxes = (boxes - lo) + (cls.to(boxes.dtype) * offset)[..., None]
        valid = torch.rand(n, k, generator=gen, device=dev) < valid_p
        return boxes.contiguous(), valid

    def planted(n, k):
        """Candidates with pairs whose IoU is exactly f32(0.45) (a 1 x 9 box
        inside a 1 x 20) at ranks 0-1 and a NaN coordinate at rank k // 2."""
        boxes, valid = candidates(n, k, 0.95)
        boxes[:, :2] = torch.tensor([[0, 0, 1, 9], [0, 0, 1, 20]], dtype=torch.float32,
                                    device="cuda")
        boxes[:, k // 2, 1] = float("nan")
        return boxes, valid

    def chain(n, k):
        """Box i at x = 3i, 10 wide: IoU 7/13 with its neighbours, 4/16
        with the next ones; greedy keeps every other rank."""
        x = torch.arange(k, device="cuda", dtype=torch.float32)[None, :].expand(n, -1) * 3
        boxes = torch.stack([x, torch.zeros_like(x), x + 10, torch.full_like(x, 10.0)], -1)
        return boxes.contiguous(), torch.ones(n, k, dtype=torch.bool, device="cuda")

    def prefix(n, k, valid_k):
        """Candidates whose first ``valid_k`` are valid: scores sorted high
        to low with most of the top K under the threshold, as at conf 0.25."""
        boxes, valid = candidates(n, k, 1.0)
        valid[:, valid_k:] = False
        return boxes, valid

    cases = {"main": candidates(N, 512, 0.95), "prefix64": prefix(N, 512, 64),
             "edges": planted(N, 512),
             "all_valid": candidates(N, 512, 1.0), "none_valid": candidates(N, 512, 0.0),
             "chain": chain(N, 512), "k1024": candidates(N, 1024, 0.95),
             "k8400": candidates(2, 8400, 0.95)}
    kept = {}
    for name, (boxes, valid) in cases.items():
        got, want = nms_keep_boxes(boxes, valid, thr), nms_keep_boxes_plain(boxes, valid, thr)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"B6 {name}: keep differs from the plain version"
        kept[name] = int(got.sum())
    boxes, valid = cases["edges"]
    got = nms_keep_boxes(boxes, valid, thr)
    assert torch.equal(got[:, 1], valid[:, 1]), "B6: an IoU of exactly f32(0.45) must not suppress"
    assert torch.equal(got[:, 256], valid[:, 256]), "B6: a NaN box must overlap nothing"
    assert torch.equal(nms_keep_boxes(*cases["chain"], thr)[0].cpu(), torch.arange(512) % 2 == 0)

    # N images at K = 8400: two chunks of words; no [N, K, K] tensor
    big_boxes, big_valid = candidates(N, 8400, 0.95)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    big = nms_keep_boxes(big_boxes, big_valid, thr)
    torch.cuda.synchronize()
    k8400_n32_peak_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
    for i in range(0, N, 4):
        want = nms_keep_boxes_plain(big_boxes[i:i + 4], big_valid[i:i + 4], thr)
        assert torch.equal(big[i:i + 4], want), f"B6 k8400 x {N}: images {i}..{i + 3} differ"
    assert k8400_n32_peak_mb < 100.0, f"B6 at K = 8400: {k8400_n32_peak_mb} MB of scratch"

    # the overlap entry: the pack pass, then the same chain
    overlaps = {name: (overlap_matrix(b, v, thr), v) for name, (b, v) in cases.items()
                if name != "k8400"}
    for name, (ov, v) in overlaps.items():
        assert torch.equal(nms_keep(ov, v), nms_keep_plain(ov, v)), f"B6 overlap entry {name}"

    boxes, valid = cases["main"]
    n, k = valid.shape

    def old_path():  # the overlap build and B6 on the matrix, as batched_nms ran before
        return nms_keep(overlap_matrix(boxes, valid, thr), valid)

    ms = cuda_ms(lambda: nms_keep_boxes(boxes, valid, thr), iters=200)
    plain_ms = cuda_ms(lambda: nms_keep_boxes_plain(boxes, valid, thr), iters=20)
    old_path_ms = cuda_ms(old_path, iters=50)
    ov_main = overlaps["main"][0]
    overlap_entry_ms = cuda_ms(lambda: nms_keep(ov_main, valid), iters=200)
    prefix64_ms = cuda_ms(lambda: nms_keep_boxes(*cases["prefix64"], thr), iters=200)
    chain_ms = cuda_ms(lambda: nms_keep_boxes(*cases["chain"], thr), iters=50)
    chain_plain_ms = cuda_ms(lambda: nms_keep_boxes_plain(*cases["chain"], thr), iters=2,
                             warmup=1)
    k8400_ms = cuda_ms(lambda: nms_keep_boxes(*cases["k8400"], thr), iters=20)
    k8400_n32_ms = cuda_ms(lambda: nms_keep_boxes(big_boxes, big_valid, thr), iters=5,
                           warmup=1)
    passes = ("nms_mask_kernel", "nms_chain_kernel")
    split = device_split_us(lambda: nms_keep_boxes(boxes, valid, thr), passes)
    split8400 = device_split_us(lambda: nms_keep_boxes(*cases["k8400"], thr), passes, calls=10)
    host = host_us(dict(kernel=lambda: nms_keep_boxes(boxes, valid, thr),
                        op=lambda: torch.ops.rva.nms_keep_boxes(boxes, valid, thr)), calls=200)
    # the work: every pair of an image once, about 12 fp32 operations
    # each; the bytes: the boxes and valid read, keep written
    pairs = n * k * (k - 1) // 2
    nbytes = n * k * 16 + 2 * n * k
    b_ms, b_by = bound(nbytes, 12.0 * pairs, torch.float32)
    row = dict(name="nms_keep", route="cuda", source="realtime_analytics_tpu_torch/csrc/nms.cu",
               replaces="realtime_analytics_tpu/ops/nms.py:134", max_abs_err=0.0, ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log("B6 " + json.dumps(dict(
        row, shape=[n, k, 4], pairs=pairs, bytes=nbytes, bit_equal=list(cases) + [
            f"k8400_x{N}"] + [f"overlap_{name}" for name in overlaps], kept=kept,
        old_path_ms=old_path_ms, overlap_entry_ms=overlap_entry_ms,
        device_us=graph_us(lambda: nms_keep_boxes(boxes, valid, thr)),
        mask_us=split["nms_mask_kernel"], chain_us=split["nms_chain_kernel"],
        host_us=host["kernel"], op_host_us=host["op"], prefix64_ms=prefix64_ms,
        prefix64_device_us=graph_us(lambda: nms_keep_boxes(*cases["prefix64"], thr)),
        chain_ms=chain_ms,
        chain_plain_ms=chain_plain_ms, k8400_ms=k8400_ms,
        k8400_mask_us=split8400["nms_mask_kernel"], k8400_chain_us=split8400["nms_chain_kernel"],
        k8400_n32_ms=k8400_n32_ms, k8400_n32_peak_mb=k8400_n32_peak_mb,
        k8400_n32_chunk=scratch_chunk(N, 8400), card=CARD)))
    return row


def stem_ptxas(lines):
    """Registers, spills, barriers and static shared memory of the stem
    kernels, from nvcc's ``-Xptxas -v`` lines: {kernel: "... spill ...; Used
    ..."}. Their shared memory is dynamic: the B3 line gives it per case."""
    out, name = {}, None
    for line in lines:
        if "Compiling entry function" in line:
            name = next((k for k in ("stem_mma_kernel", "stem_general_kernel")
                         if k in line), None)
            if name == "stem_general_kernel":  # the mangled template argument
                name += "<bf16>" if "nv_bfloat16" in line else "<fp32>"
        elif name and ("Used" in line or "spill" in line):
            fact = line.split("info    :")[-1].strip()
            out[name] = f"{out[name]}; {fact}" if name in out else fact
    return out


def check_stem(gen):
    import torch.nn.functional as F

    from realtime_analytics_tpu_torch.ops.stem import (
        fused_stem_p1p2,
        fused_stem_p1p2_plain,
        prepare_stem,
        stem_instantiation,
        stem_smem_bytes,
    )

    def case(name, dtype, shape, c0, c1, want_kind, timed):
        n, h, w = shape
        w0 = torch.randn(c0, 3, 3, 3, generator=gen, device="cuda") * (2 / 27) ** 0.5 / 255
        b0 = torch.randn(c0, generator=gen, device="cuda") * 0.05
        w1 = torch.randn(c1, c0, 3, 3, generator=gen, device="cuda") * (2 / (9 * c0)) ** 0.5
        b1 = torch.randn(c1, generator=gen, device="cuda") * 0.05
        sw = prepare_stem(w0, b0, w1, b1, dtype)
        x = torch.randint(0, 256, (n, h, w, 3), generator=gen, device="cuda",
                          dtype=torch.uint8).to(dtype)  # raw pixels (stem-folded weights)
        kind = stem_instantiation(dtype, c0, c1, w)
        assert kind == want_kind, f"B3 {name} took {kind}, not {want_kind}"
        got, want = fused_stem_p1p2(x, sw), fused_stem_p1p2_plain(x, sw)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == dtype and got.is_contiguous()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        # bf16: P1 is rounded to bf16 in both, so an fp32 accumulation-order
        # difference can flip one P1 rounding: allow 1% of the output range;
        # fp32: accumulation order only
        tol = 1e-2 * scale if dtype == torch.bfloat16 else 1e-4
        log(f"B3 {name} ({kind} kernel) {str(dtype)[6:]} x{list(x.shape)} c0={c0} c1={c1}: "
            f"max abs err {err:.3g} (tol {tol:.3g}, max |out| {scale:.3g})")
        assert err <= tol, f"B3 {name} disagrees"
        del got, want
        row = dict(kernel=kind, shape=list(x.shape), c0=c0, c1=c1, max_abs_err=err,
                   smem_bytes=stem_smem_bytes(c0, c1, kind))  # dynamic: not in ptxas -v
        if not timed:
            return row
        ms = cuda_ms(lambda: fused_stem_p1p2(x, sw), iters=20)
        plain_ms = cuda_ms(lambda: fused_stem_p1p2_plain(x, sw), iters=10)
        xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view
        w0c, w1c = w0.to(dtype), w1.to(dtype)
        b0c, b1c = b0.to(dtype), b1.to(dtype)
        chain_ms = cuda_ms(lambda: F.silu(F.conv2d(
            F.silu(F.conv2d(xc, w0c, b0c, stride=2, padding=1)), w1c, b1c,
            stride=2, padding=1)), iters=10)
        esz = 2 if dtype == torch.bfloat16 else 4
        nbytes = n * h * w * 3 * esz + n * (h // 4) * (w // 4) * c1 * esz
        flops = 2.0 * n * ((h // 2) * (w // 2) * c0 * 27 + (h // 4) * (w // 4) * c1 * 9 * c0)
        b_ms, b_by = bound(nbytes, flops, dtype)
        row.update(ms=ms, plain_ms=plain_ms, cudnn_chain_ms=chain_ms, bound_ms=b_ms,
                   bound_by=b_by, bytes=nbytes, flops=flops)
        return row

    b16, f32 = torch.bfloat16, torch.float32
    out = {
        "bf16": case("v8n", b16, (N, HW, HW), 16, 32, "mma", True),  # the main path
        "fp32": case("v8n", f32, (N, HW, HW), 16, 32, "general", True),
        "bf16_v8s": case("v8s", b16, (N, HW, HW), 32, 64, "mma", True),
        "fp32_ragged": case("ragged", f32, (2, 68, 36), 32, 64, "general", False),
        "bf16_8_24": case("odd widths", b16, (2, 64, 64), 8, 24, "general", False),
        "bf16_ragged": case("ragged", b16, (3, 72, 40), 16, 32, "mma", False),
    }
    torch.cuda.empty_cache()
    log("B3 " + json.dumps(dict(out, card=CARD)))
    bf = out["bf16"]
    return dict(name="fused_stem", route="cuda",
                source="realtime_analytics_tpu_torch/csrc/stem.cu",
                replaces="realtime_analytics_tpu/ops/pallas_stem.py:136",
                max_abs_err=bf["max_abs_err"], ms=bf["ms"], plain_ms=bf["plain_ms"],
                bound_ms=bf["bound_ms"], bound_by=bf["bound_by"], library_ms=None)


def letterbox_bound(spec, n: int, dtype: torch.dtype):
    """(bound ms, binds, bytes, flops) of B4 on ``n`` frames: each source
    row that a tap with a nonzero weight touches, read once; the canvas
    written once; about 15 fp32 operations per content value."""
    from realtime_analytics_tpu_torch.ops.letterbox import bilinear_taps

    i0, i1, w = bilinear_taps(spec.src_h, spec.new_h)
    rows = len(np.union1d(i0[w < 1], i1[w > 0]))
    esz = 2 if dtype == torch.bfloat16 else 4
    nbytes = (n * rows * spec.src_w * 3 + n * spec.dst_h * spec.dst_w * 3 * esz
              + 12 * (spec.new_h + spec.new_w))
    flops = 15.0 * n * spec.new_h * spec.new_w * 3
    t_ms, by = bound(nbytes, flops, torch.float32)
    return t_ms, by, nbytes, flops, rows


def check_letterbox(gen):
    """B4 against its plain version, one case per H mode of the TPU kernel,
    the ResNet and clip stretches, and a source width whose rows are not
    whole 16-byte units. Held: the pad exactly 114/255 and the whole canvas
    bit-equal to the plain version (both run the same tables in the same
    fp32 order without FMA; a tap of weight 0 that the kernel leaves out
    changes no bit)."""
    import torch.nn.functional as F

    from realtime_analytics_tpu_torch.ops.letterbox import (
        letterbox,
        letterbox_instantiation,
        letterbox_plain,
        letterbox_plan,
        stretch_spec,
    )
    from realtime_analytics_tpu_torch.ops.preprocess import letterbox_spec

    # the temporal clip steps stretch 4 clips x 16 frames = 64 frames
    cases = (("select", N, (1080, 1920), (640, 640), False, torch.bfloat16),
             ("select_f32", N, (1080, 1920), (640, 640), False, torch.float32),  # ONNX graph
             ("mean2", N, (720, 1280), (640, 640), False, torch.bfloat16),
             ("matmul", N, (1520, 2688), (640, 640), False, torch.bfloat16),
             ("stretch", N, (1080, 1920), (224, 224), True, torch.float32),
             ("clip_224", 64, (1080, 1920), (224, 224), True, torch.float32),
             ("clip_112", 64, (1080, 1920), (112, 112), True, torch.float32),
             ("odd_width", 8, (97, 211), (128, 128), False, torch.bfloat16))
    rows = {}
    for name, n, src, dst, stretch, dtype in cases:
        frames = torch.randint(0, 256, (n, *src, 3), generator=gen, device="cuda",
                               dtype=torch.uint8)
        spec = stretch_spec(src, dst) if stretch else letterbox_spec(src, dst)
        kind = letterbox_instantiation(spec.src_w, spec.dst_w, dtype,
                                       frames.data_ptr() % 16 == 0)
        assert kind == ("element" if name == "odd_width" else "vec16"), f"B4 {name}: {kind}"
        plan = letterbox_plan(spec, dtype, kind)
        got, want = letterbox(frames, spec, dtype), letterbox_plain(frames, spec, dtype)
        torch.cuda.synchronize()
        bit_equal = torch.equal(got, want)
        content = torch.zeros(dst, dtype=torch.bool, device="cuda")
        content[spec.pad_top:spec.pad_top + spec.new_h,
                spec.pad_left:spec.pad_left + spec.new_w] = True
        # the pad: bit-equal to the plain version's (114 x fp32(1/255), as
        # the reference computes it), and 114/255 to the output's precision
        pad = got[:, ~content].float()  # empty for the stretch
        pad_exact = bool((got[:, ~content] == want[:, ~content]).all()) and bool(
            ((pad - 114.0 / 255.0).abs()
             <= (2.0 ** -10 if dtype == torch.bfloat16 else 1e-7)).all())
        del pad
        diff = (got.float() - want.float()).abs()[:, content]
        err = diff.max().item()
        share = (diff.amax(-1) > 0).float().mean().item()
        log(f"B4 {name} ({kind}, {'span' if plan.dense else 'in place'}) {n}x{src}->{dst} "
            f"{str(dtype)[6:]}: bit-equal {bit_equal}, pad exact {pad_exact}, max |content| "
            f"err {err:.4g}, pixels differing {share:.5f}")
        assert pad_exact and bit_equal, f"B4 {name} disagrees"
        ms = cuda_ms(lambda: letterbox(frames, spec, dtype), iters=20)
        plain_ms = cuda_ms(lambda: letterbox_plain(frames, spec, dtype), iters=5, warmup=1)
        nchw = frames.permute(0, 3, 1, 2).float()  # the resize alone, no round/pad/flip
        lib_ms = cuda_ms(lambda: F.interpolate(nchw, size=(spec.new_h, spec.new_w),
                                               mode="bilinear", align_corners=False),
                         iters=10, warmup=2)
        del nchw, got, want
        b_ms, b_by, nbytes, flops, tapped = letterbox_bound(spec, n, dtype)
        rows[name] = dict(n=n, src=list(src), dst=list(dst), dtype=str(dtype)[6:],
                          kernel=kind, staging="span" if plan.dense else "in_place",
                          seg_w=plan.seg_w, smem_bytes=plan.smem_bytes, max_abs_err=err,
                          pixels_differing=share, ms=ms, plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                          flops=flops, rows_tapped=tapped)
    log("B4 " + json.dumps(dict(rows, card=CARD)))
    yolo = rows["mean2"]  # the YOLO device-resize step's shape (phase 5)
    return dict(name="letterbox", route="cuda",
                source="realtime_analytics_tpu_torch/csrc/letterbox.cu",
                replaces="realtime_analytics_tpu/ops/pallas_preprocess.py:66",
                max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                ms=yolo["ms"], plain_ms=yolo["plain_ms"], bound_ms=yolo["bound_ms"],
                bound_by=yolo["bound_by"], library_ms=yolo["library_ms"])


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def require_launched(path: str, launches, names) -> None:
    for name in names:
        assert launches[name] > 0, f"kernel {name} was not launched on the {path}"


def require_counts(path: str, launches, want) -> None:
    """Each kernel of ``want`` launched exactly that many times on the path."""
    for name, n in want.items():
        assert launches[name] == n, f"{path}: {name} launched {launches[name]} times, not {n}"


def detector_config(**over):
    from realtime_analytics_tpu_torch.config import DetectorConfig

    kw = dict(model_path="chip-smoke-seeded-weights", device="cuda",
              confidence_threshold=0.005, warmup=False, input_size=[HW, HW],
              max_batch_size=N, batch_buckets=[N], precision="bf16")
    kw.update(over)
    return DetectorConfig(**kw)


def compare(a, b):
    """Detections of two engines frame by frame, slot by slot: the frames
    whose num_valid and classes agree, and over those frames the largest
    score and box differences of the valid slots."""
    same, score_d, box_d = 0, 0.0, 0.0
    for i in range(len(a.num_valid)):
        n = int(a.num_valid[i])
        if n != int(b.num_valid[i]) or not np.array_equal(a.class_ids[i, :n],
                                                          b.class_ids[i, :n]):
            continue
        same += 1
        score_d = max(score_d, float(np.abs(a.scores[i, :n] - b.scores[i, :n]).max(initial=0)))
        box_d = max(box_d, float(np.abs(a.boxes_xyxy[i, :n] - b.boxes_xyxy[i, :n]).max(initial=0)))
    return same, score_d, box_d


def model_outputs(eng, frames, reduce_scores=True):
    """The engine's model outputs (before NMS) on its selected-step input:
    the host pick, then pad + cast on the card, as ``_step_selected``;
    every class's score when not ``reduce_scores``."""
    from realtime_analytics_tpu_torch.ops.preprocess import letterbox_spec

    spec = letterbox_spec(frames.shape[1:3], eng.input_hw)
    sel, selected = eng.host_prepare(frames, frames.shape[1:3])
    assert selected
    with torch.inference_mode():
        x = eng._pad_cast(torch.from_numpy(sel).cuda(), spec)
        out = (eng._forward_selected(x) if reduce_scores else
               eng.model(x, w0=eng._w0_folded, stem_weights=eng._stem_folded))
    return {k: v.float() for k, v in out.items()}


def hold(name, a, b, score_tol, box_tol):
    """Detections of two engines agree on every frame: num_valid and
    classes equal, scores and boxes within the tolerances."""
    same, score_d, box_d = compare(a, b)
    n = len(a.num_valid)
    log(f"{name}: {same}/{n} frames with equal num_valid and classes, max "
        f"|score| delta {score_d:.3g} (tol {score_tol}), max |box| delta "
        f"{box_d:.3g} px (tol {box_tol})")
    assert same == n and score_d <= score_tol and box_d <= box_tol, f"{name} disagree"
    return same, score_d, box_d


def run_engine(params, frames):
    from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine
    from realtime_analytics_tpu_torch.ops import _cuda

    off = dict(pallas_gather="off", pallas_decode="off", pallas_stem="off")
    eng = TorchYoloEngine(detector_config(), params=params)
    eng.predict_arrays(frames)  # first call: allocator, cuDNN plans
    torch.cuda.synchronize()
    _cuda.LAUNCHES.reset()
    res = eng.predict_arrays(frames)  # THE main-path run
    launches = _cuda.LAUNCHES.snapshot()
    log(f"main path launches {json.dumps(launches)}")
    require_launched("main path", launches, ("row_gather", "decode_v8", "fused_stem",
                                             "nms_keep"))
    assert launches["decode_v8"] == 1, "the head must decode in one launch a step"
    assert launches["nms_keep"] == 1, "NMS's keep pass must be one launch a step"
    b = res.boxes_xyxy
    assert b.shape == (N, 300, 4) and np.isfinite(b).all() and np.isfinite(res.scores).all()
    summary_res = res
    assert (res.num_valid > 0).all(), "no detections on a frame at conf 0.005"
    log(f"main path num_valid per frame {res.num_valid.tolist()}")

    # bf16, model outputs before NMS, every kernel on vs off: within the
    # repo's bf16 fidelity bound (tests/test_bf16_fidelity.py: score delta
    # < 0.02, median box drift < 1 px). The fused stem rounds P1 to bf16
    # once where the layer chain rounds the conv, bias and SiLU outputs
    # each, so the two differ by bf16 roundings from node 1 on.
    ref = TorchYoloEngine(detector_config(**off), params=params)
    got, want = model_outputs(eng, frames), model_outputs(ref, frames)
    conf_d = (got["conf"] - want["conf"]).abs().max().item()
    box_med = (got["boxes_xyxy"] - want["boxes_xyxy"]).abs().median().item()
    cls_agree = (got["cls"] == want["cls"]).float().mean().item()
    log(f"bf16 model outputs, kernels on vs off: max |conf| delta {conf_d:.4g} "
        f"(< 0.02), median |box| delta {box_med:.4g} px (< 1), class agreement "
        f"{cls_agree:.4f}")
    assert conf_d < 0.02 and box_med < 1.0, "bf16 model outputs drift"
    # Those roundings reorder the near-tied scores of a seeded model at
    # conf 0.005, so after NMS the all-off engine keeps other boxes
    # (reported). Held after NMS in bf16: B1 and B2 against their plain
    # versions, with the stem the same on both sides.
    all_off, _, _ = compare(res, ref.predict_arrays(frames))
    log(f"bf16 detections, every kernel on vs off: {all_off}/{N} frames with "
        "equal num_valid and classes (reported, not held)")
    stem_only = TorchYoloEngine(
        detector_config(pallas_gather="off", pallas_decode="off"), params=params)
    hold("bf16 detections, B1 + B2 on vs off (B3 on in both)", res,
         stem_only.predict_arrays(frames), score_tol=1e-5, box_tol=1e-3)
    # fp32, after NMS, every kernel on vs off: held
    on32 = TorchYoloEngine(detector_config(precision="fp32"), params=params)
    off32 = TorchYoloEngine(detector_config(precision="fp32", **off), params=params)
    _, score32, box32 = hold("fp32 detections, every kernel on vs off",
                             on32.predict_arrays(frames), off32.predict_arrays(frames),
                             score_tol=1e-4, box_tol=1e-2)
    del ref, stem_only, on32, off32

    torch.cuda.reset_peak_memory_stats()
    step_ms, step_min = timed_ms(lambda: eng.predict_arrays(frames), 25)
    mem = torch.cuda.max_memory_allocated() / 2**20
    waits = host_waits(eng, frames)
    summary = dict(step_ms_median=step_ms, step_ms_min=step_min, host_waits_per_step=waits,
                   frames_per_s=N / step_ms * 1e3, max_memory_allocated_mib=mem,
                   bf16_conf_max_delta=conf_d, bf16_box_median_delta_px=box_med,
                   bf16_class_agreement=cls_agree, bf16_all_off_frames_equal=all_off,
                   fp32_score_max_delta=score32, fp32_box_max_delta_px=box32)
    return launches, summary, summary_res


# ---------------------------------------------------------------------------
# phases 6-8: native int8, YOLOv5, tiled inference
# ---------------------------------------------------------------------------


def host_waits(eng, frames):
    """A main step with NMS's keep pass three ways: the fixpoint sweeps (a
    host wait a sweep), the overlap build and B6 on the matrix
    (``nms_keep``: the path before B6 took the boxes), and B6 on the boxes.
    For each, ``profile_step.py``'s trace over 2 steps (host calls that wait
    for the card, kernels and device ms a step) and its select + NMS stage
    (host clock, synchronised, median of 10); B6 on the boxes is read again
    last, so that a drift of the host shows."""
    from realtime_analytics_tpu_torch.ops import nms
    from realtime_analytics_tpu_torch.scripts.profile_step import stage_times, trace

    kernel = nms.nms_keep_boxes
    variants = dict(
        b6=kernel, overlap_b6=lambda b, v, t: nms.nms_keep(nms.overlap_matrix(b, v, t), v),
        sweeps=nms.nms_keep_boxes_plain)
    out = {}
    try:
        for name, fn in variants.items():
            nms.nms_keep_boxes = fn
            tr = trace(eng, frames, 2)
            out[name] = dict(
                host_waits=tr["host_waits_per_step"],
                host_waits_total=sum(tr["host_waits_per_step"].values()),
                kernels_per_step=tr["kernels_per_step"],
                device_ms_per_step=tr["device_ms_per_step"],
                select_nms_ms=stage_times(eng, frames, 10)["select_nms"])
    finally:
        nms.nms_keep_boxes = kernel
    out["b6"]["select_nms_ms_again"] = stage_times(eng, frames, 10)["select_nms"]
    log("main step host waits " + json.dumps(dict(out, card=CARD)))
    assert out["b6"]["host_waits_total"] < out["sweeps"]["host_waits_total"], \
        "B6 must remove the sweeps' host waits"
    assert out["b6"]["kernels_per_step"] < out["overlap_b6"]["kernels_per_step"], \
        "B6 on the boxes must take the overlap build's kernels out of the step"
    return out


def iou(a, b) -> float:
    tl, br = np.maximum(a[:2], b[:2]), np.minimum(a[2:], b[2:])
    inter = float(np.prod(np.clip(br - tl, 0, None)))
    ua = float(np.prod(np.clip(a[2:] - a[:2], 0, None)))
    ub = float(np.prod(np.clip(b[2:] - b[:2], 0, None)))
    return inter / max(ua + ub - inter, 1e-9)


def matched(got, ref, i: int, k: int, score_tol: float):
    """How many of frame i's top-k reference detections have a counterpart
    in ``got``: the same class, IoU > 0.6, a score within ``score_tol``."""
    k = min(k, int(ref.num_valid[i]))
    hits = sum(
        any(got.class_ids[i, g] == ref.class_ids[i, r]
            and iou(got.boxes_xyxy[i, g], ref.boxes_xyxy[i, r]) > 0.6
            and abs(float(got.scores[i, g]) - float(ref.scores[i, r])) < score_tol
            for g in range(int(got.num_valid[i])))
        for r in range(k))
    return hits, k


def check_int8_acc(eng, frames):
    """The int32 accumulators of the int8 conv on the card against a
    float64 convolution of the same int8 operands, for equality: the
    selected step's folded stem (raw pixels, K 27 padded to 32) and the
    first 3x3 conv with at least 64 input channels, on the activations the
    step gives them. Also the int8 conv's time beside cuDNN's bf16 conv at
    each shape."""
    import torch.nn.functional as F

    from realtime_analytics_tpu_torch.models.layers import ConvAct
    from realtime_analytics_tpu_torch.ops.int8 import conv2d_int8, conv2d_int8_acc, quantize_act
    from realtime_analytics_tpu_torch.ops.preprocess import letterbox_spec

    spec = letterbox_spec(frames.shape[1:3], eng.input_hw)
    sel, _ = eng.host_prepare(frames, frames.shape[1:3])
    name, conv = next((n, m) for n, m in eng.model.named_modules()
                      if isinstance(m, ConvAct) and m.shape[1] >= 64 and m.shape[2] == 3)
    seen = {}
    hook = conv.register_forward_pre_hook(lambda _m, args: seen.setdefault("x", args[0]))
    with torch.inference_mode():
        x0 = eng._pad_cast(torch.from_numpy(sel).to(eng.device), spec).permute(0, 3, 1, 2)
        eng._forward_selected(x0.permute(0, 2, 3, 1))
    hook.remove()
    stem = eng.model.layers["0"]
    rows = {}
    for label, mod, x, q in (("stem", stem, x0, eng._w0_folded),
                             (name, conv, seen["x"], conv.quant())):
        cout, k = mod.shape[0], mod.shape[-1]
        with torch.inference_mode():
            acc, scale = conv2d_int8_acc(x, q, cout, k, stride=mod.stride, padding=mod.padding)
            xq = quantize_act(x.permute(0, 2, 3, 1).float(), scale)
            pad = k // 2 if mod.padding is None else mod.padding
            ref = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                           mod.w_q.flip(1).double() if mod is stem else mod.w_q.double(),
                           stride=mod.stride, padding=pad)
            torch.cuda.synchronize()
            equal = torch.equal(acc.double(), ref.permute(0, 2, 3, 1))
            log(f"int8 conv {label}: x {list(x.shape)} K {k * k * mod.shape[1]} -> "
                f"{q.w_pack.shape[1]}, int32 accumulators equal to the float64 conv: {equal}")
            assert equal, f"int8 conv {label}: accumulators differ"
            xb, wb, bb = x.to(torch.bfloat16), mod.plain_weight(torch.bfloat16), \
                mod.bias.to(torch.bfloat16)
            a = torch.zeros(acc.shape[0] * acc.shape[1] * acc.shape[2], q.w_pack.shape[1],
                            dtype=torch.int8, device=x.device)  # the product's shape alone
            rows[label] = dict(
                x=list(x.shape), k=k, cout=cout, k_padded=q.w_pack.shape[1], exact=equal,
                int8_ms=cuda_ms(lambda: conv2d_int8(x, q, mod.bias, cout, k, stride=mod.stride,
                                                    padding=mod.padding), iters=10),
                int_mm_ms=cuda_ms(lambda: torch._int_mm(a, q.w_pack.t()), iters=10),
                bf16_cudnn_ms=cuda_ms(lambda: F.conv2d(xb, wb, bb, stride=mod.stride,
                                                       padding=pad), iters=10))
            del a
        del acc, ref, xq
    torch.cuda.empty_cache()
    return rows


def run_int8(params, frames, bf16_res, bf16_summary):
    """YOLOv8n with ``precision: int8`` on the main path's frames: the
    engine quantises the weights and calibrates on the card; held against
    the bf16 engine's detections (the JAX package's int8 gate,
    tests/test_int8.py:85)."""
    from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine
    from realtime_analytics_tpu_torch.models.layers import ConvAct
    from realtime_analytics_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    eng = TorchYoloEngine(detector_config(precision="int8"), params=params)
    build_s = time.perf_counter() - t0
    convs = [(n, m) for n, m in eng.model.named_modules() if isinstance(m, ConvAct)]
    missing = [n for n, m in convs if m.a_scale is None]
    assert not missing, f"int8: convs without a calibrated a_scale: {missing}"
    assert all(m.w_q is not None and m.weight is None for _, m in convs)
    acc = check_int8_acc(eng, frames)
    eng.predict_arrays(frames)
    torch.cuda.synchronize()
    _cuda.LAUNCHES.reset()
    res = eng.predict_arrays(frames)
    launches = _cuda.LAUNCHES.snapshot()
    log(f"int8 path launches {json.dumps(launches)}")
    assert (launches["decode_v8"], launches["row_gather"], launches["fused_stem"],
            launches["nms_keep"]) == (1, 2, 0, 1), \
        "int8 step: B2 once, B1 twice, B3 never, B6 once"
    assert np.isfinite(res.boxes_xyxy).all() and (res.num_valid > 0).all()
    shares = []
    for i in range(N):
        hits, k = matched(res, bf16_res, i, k=8, score_tol=0.1)
        n_ref, n_got = int(bf16_res.num_valid[i]), int(res.num_valid[i])
        shares.append(hits / max(k, 1))
        assert k > 0 and hits >= max(1, int(0.7 * k)), f"int8 frame {i}: {hits}/{k} matched"
        assert abs(n_ref - n_got) <= max(3, n_ref // 2), f"int8 frame {i}: {n_got} vs {n_ref}"
    log(f"int8 detections against bf16: top-8 matched (same class, IoU > 0.6, |score| < "
        f"0.1) on {sum(shares) / N:.3f} of slots, least frame {min(shares):.3f} (>= 0.7)")
    torch.cuda.reset_peak_memory_stats()
    step_ms, step_min = timed_ms(lambda: eng.predict_arrays(frames), 10)
    summary = dict(step_ms_median=step_ms, step_ms_min=step_min,
                   frames_per_s=N / step_ms * 1e3,
                   max_memory_allocated_mib=torch.cuda.max_memory_allocated() / 2**20,
                   bf16_step_ms_median=bf16_summary["step_ms_median"],
                   bf16_frames_per_s=bf16_summary["frames_per_s"],
                   bf16_max_memory_allocated_mib=bf16_summary["max_memory_allocated_mib"],
                   engine_build_s=build_s, calibrated_convs=len(convs),
                   top8_matched_share_mean=sum(shares) / N, top8_matched_share_min=min(shares),
                   convs=acc)
    del eng
    torch.cuda.empty_cache()
    return launches, summary


def run_yolov5(frames):
    """YOLOv5n, bf16, on the main path's frames (selected step): B1 only;
    bf16 model outputs against fp32 within the repo's bf16 fidelity bound
    (tests/test_bf16_fidelity.py: score delta < 0.02, median box drift < 1
    px); fp32 detections with B1 on against off on the same engine."""
    from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine
    from realtime_analytics_tpu_torch.models.weights import synthetic_params
    from realtime_analytics_tpu_torch.models.yolo import build_yolo
    from realtime_analytics_tpu_torch.ops import _cuda

    params = synthetic_params(build_yolo("yolov5", "n", 80), seed=0)
    eng = TorchYoloEngine(detector_config(model_type="yolov5"), params=params)
    assert eng.model.version == 5
    eng.predict_arrays(frames)
    torch.cuda.synchronize()
    _cuda.LAUNCHES.reset()
    res = eng.predict_arrays(frames)
    launches = _cuda.LAUNCHES.snapshot()
    log(f"yolov5 path launches {json.dumps(launches)}")
    assert (launches["row_gather"], launches["fused_stem"], launches["decode_v8"],
            launches["nms_keep"]) == (2, 0, 0, 1), \
        "v5 step: B1 twice, B6 once, no B2 (a v5 head) and no B3 (a k6 stem)"
    assert res.boxes_xyxy.shape == (N, 300, 4) and np.isfinite(res.boxes_xyxy).all()
    assert (res.num_valid > 0).all()
    fp32 = TorchYoloEngine(detector_config(model_type="yolov5", precision="fp32"),
                           params=params)
    got, want = model_outputs(eng, frames), model_outputs(fp32, frames)
    conf_d = (got["conf"] - want["conf"]).abs().max().item()
    box_med = (got["boxes_xyxy"] - want["boxes_xyxy"]).abs().median().item()
    cls_agree = (got["cls"] == want["cls"]).float().mean().item()
    log(f"yolov5 bf16 against fp32 model outputs: max |conf| delta {conf_d:.4g} (< 0.02), "
        f"median |box| delta {box_med:.4g} px (< 1), class agreement {cls_agree:.4f}")
    assert conf_d < 0.02 and box_med < 1.0, "yolov5 bf16 outputs drift from fp32"
    # B1 on the v5 boxes [N, 25200, 4]: the same engine and model outputs,
    # NMS gathering through the kernel and then through torch
    on = fp32.predict_arrays(frames)
    fp32._nms_gather = "torch"
    off = fp32.predict_arrays(frames)
    assert (on.num_valid > 0).all()
    _, score_g, box_g = hold("yolov5 fp32 detections, B1 on vs off", on, off,
                             score_tol=1e-5, box_tol=1e-3)
    del fp32, got, want
    torch.cuda.reset_peak_memory_stats()
    step_ms, step_min = timed_ms(lambda: eng.predict_arrays(frames), 10)
    summary = dict(step_ms_median=step_ms, step_ms_min=step_min,
                   frames_per_s=N / step_ms * 1e3,
                   max_memory_allocated_mib=torch.cuda.max_memory_allocated() / 2**20,
                   bf16_conf_max_delta_vs_fp32=conf_d, bf16_box_median_delta_vs_fp32_px=box_med,
                   bf16_class_agreement_vs_fp32=cls_agree,
                   fp32_b1_on_off_score_max_delta=score_g,
                   fp32_b1_on_off_box_max_delta_px=box_g,
                   num_valid_mean=float(res.num_valid.mean()))
    del eng
    torch.cuda.empty_cache()
    return launches, summary


def run_tiled(params, frames):
    """Tiled inference on 1080p frames: 8 tiles of 640x640 a frame in
    steps of the bucket (32 tiles), then the whole-frame pass; every step
    must launch B1 twice, B2 and B3 once. fp32 detections, every kernel on
    against every kernel off, frame by frame."""
    from realtime_analytics_tpu_torch.config import StreamConfig
    from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine
    from realtime_analytics_tpu_torch.ops import _cuda
    from realtime_analytics_tpu_torch.types import FramePacket

    packets = [FramePacket(StreamConfig(name=f"cam-{i}", url="synthetic://"), f, i, 0.0)
               for i, f in enumerate(frames)]

    def engine(**over):
        eng = TorchYoloEngine(detector_config(tiling=True, tiling_full_frame=True, **over),
                              params=params)
        steps = []
        run = eng._run_bucket

        def counted(bucket, prepared, src_hw, selected):
            before = _cuda.LAUNCHES.snapshot()
            out = run(bucket, prepared, src_hw, selected)
            after = _cuda.LAUNCHES.snapshot()
            steps.append((tuple(src_hw), len(prepared), {k: after[k] - before[k] for k in after}))
            return out

        eng._run_bucket = counted
        return eng, steps

    eng, steps = engine()
    eng.predict_packets(packets)
    torch.cuda.synchronize()
    steps.clear()
    _cuda.LAUNCHES.reset()
    dets = eng.predict_packets(packets)
    launches = _cuda.LAUNCHES.snapshot()
    log(f"tiled path launches {json.dumps(launches)}; steps "
        f"{json.dumps([[list(hw), n, c] for hw, n, c in steps])}")
    tile_steps = [c for hw, _, c in steps if hw == (HW, HW)]
    n_tiles = sum(n for hw, n, _ in steps if hw == (HW, HW))
    assert n_tiles == 8 * len(frames) and len(tile_steps) == -(-n_tiles // N)
    assert len(steps) == len(tile_steps) + 1, "the whole-frame pass is one more step"
    for c in (c for _, _, c in steps):
        assert (c["fused_stem"], c["decode_v8"], c["row_gather"], c["nms_keep"]) == (1, 1, 2, 1), \
            f"a tiled step did not launch B1-B3 and B6: {c}"
    assert all(isinstance(d, list) for d in dets) and sum(len(d) for d in dets) > 0

    off = dict(pallas_gather="off", pallas_decode="off", pallas_stem="off")
    on32, _ = engine(precision="fp32", confidence_threshold=0.25)
    off32, _ = engine(precision="fp32", confidence_threshold=0.25, **off)
    a, b = on32.predict_packets(packets), off32.predict_packets(packets)
    same, score_d, box_d = 0, 0.0, 0.0
    for da, db in zip(a, b):
        # the merge orders by score, so detections from two tiles whose
        # scores tie to fp32 precision may swap slots: pair each with the
        # nearest box of its class on the other side
        if len(da) != len(db) or sorted(d.class_id for d in da) != sorted(
                d.class_id for d in db):
            continue
        same += 1
        free = list(db)
        for x in da:
            y = min((d for d in free if d.class_id == x.class_id),
                    key=lambda d: np.abs(np.subtract(x.bbox_xyxy, d.bbox_xyxy)).max())
            free.remove(y)
            score_d = max(score_d, abs(x.confidence - y.confidence))
            box_d = max(box_d, float(np.abs(np.subtract(x.bbox_xyxy, y.bbox_xyxy)).max()))
    log(f"tiled fp32 detections, every kernel on vs off: {same}/{len(frames)} frames with "
        f"equal counts and classes, each detection paired with its nearest box of the same "
        f"class: max |score| delta {score_d:.3g} (tol 1e-4), max |box| delta {box_d:.3g} px "
        f"(tol 1e-2)")
    assert same == len(frames) and score_d <= 1e-4 and box_d <= 1e-2, "tiled fp32 disagree"
    del on32, off32
    n_steps = len(steps)
    torch.cuda.reset_peak_memory_stats()
    ms, ms_min = timed_ms(lambda: eng.predict_packets(packets), 5)
    summary = dict(frames=len(frames), tiles=n_tiles, steps=n_steps,
                   tile_steps=len(tile_steps), detections=sum(len(d) for d in dets),
                   ms_median=ms, ms_min=ms_min, ms_per_frame=ms / len(frames),
                   max_memory_allocated_mib=torch.cuda.max_memory_allocated() / 2**20,
                   fp32_frames_equal=same, fp32_score_max_delta=score_d,
                   fp32_box_max_delta_px=box_d)
    del eng
    torch.cuda.empty_cache()
    return launches, summary


# ---------------------------------------------------------------------------
# phases 9-10: the classifier and temporal paths that run B4
# ---------------------------------------------------------------------------


def run_device_resize(params, frames):
    """The YOLO device-resize step on full 1280x720 frames: B4 letterbox
    (H and W mean2: 720p -> 640x360 content), forward with the plain stem
    weights, NMS."""
    from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine
    from realtime_analytics_tpu_torch.ops import _cuda
    from realtime_analytics_tpu_torch.ops.preprocess import letterbox_spec

    eng = TorchYoloEngine(detector_config(host_resize="off"), params=params)
    spec = letterbox_spec(frames.shape[1:3], eng.input_hw)
    assert not eng.host_prepare(frames, frames.shape[1:3])[1], "not the device-resize step"
    eng.predict_arrays(frames)
    torch.cuda.synchronize()
    _cuda.LAUNCHES.reset()
    res = eng.predict_arrays(frames)
    launches = _cuda.LAUNCHES.snapshot()
    log(f"device-resize path launches {json.dumps(launches)}")
    require_launched("device-resize path", launches,
                     ("letterbox", "fused_stem", "decode_v8", "row_gather", "nms_keep"))
    assert launches["decode_v8"] == 1, "the head must decode in one launch a step"
    assert launches["nms_keep"] == 1, "NMS's keep pass must be one launch a step"
    assert np.isfinite(res.boxes_xyxy).all() and (res.num_valid > 0).all()

    # bf16 model outputs, B4 on vs off, within the bf16 fidelity bound. At
    # this geometry both letterboxes compute (a + b) / 2 on both axes,
    # which is exact in fp32, so their inputs must be bit-equal.
    off = TorchYoloEngine(detector_config(host_resize="off", pallas_preprocess="off"),
                          params=params)

    def outputs(e):
        with torch.inference_mode():
            x = e._device_letterbox(torch.from_numpy(frames).cuda(), spec)
            out = e.model(x, reduce_scores=True, stem_weights=e._stem_plain)
        return x, {k: v.float() for k, v in out.items()}

    (x_on, got), (x_off, want) = outputs(eng), outputs(off)
    input_d = (x_on.float() - x_off.float()).abs().max().item()
    conf_d = (got["conf"] - want["conf"]).abs().max().item()
    box_med = (got["boxes_xyxy"] - want["boxes_xyxy"]).abs().median().item()
    log(f"device resize, bf16, B4 on vs off: max |input| delta {input_d:.3g} (0: the "
        f"mean2 taps are exact), max |conf| delta {conf_d:.4g} (< 0.02), median |box| "
        f"delta {box_med:.4g} px (< 1)")
    assert input_d == 0.0 and conf_d < 0.02 and box_med < 1.0, "B4 device resize drifts"
    del x_on, x_off, got, want, off
    # fp32 detections, B4 on vs off: the same input bits, so only the two
    # engines' cuDNN algorithm choices may differ: held to 1e-5 / 1e-3 px
    on32, off32 = (TorchYoloEngine(detector_config(
        host_resize="off", precision="fp32", confidence_threshold=0.25, pallas_preprocess=m),
        params=params) for m in ("auto", "off"))
    _, score32, box32 = hold("device resize, fp32 detections, B4 on vs off",
                             on32.predict_arrays(frames), off32.predict_arrays(frames),
                             score_tol=1e-5, box_tol=1e-3)
    del on32, off32
    torch.cuda.reset_peak_memory_stats()
    step_ms, step_min = timed_ms(lambda: eng.predict_arrays(frames), 10)
    summary = dict(src=list(frames.shape[1:3]), step_ms_median=step_ms, step_ms_min=step_min,
                   frames_per_s=N / step_ms * 1e3,
                   max_memory_allocated_mib=torch.cuda.max_memory_allocated() / 2**20,
                   bf16_input_max_delta=input_d, bf16_conf_max_delta=conf_d,
                   bf16_box_median_delta_px=box_med, fp32_score_max_delta=score32,
                   fp32_box_max_delta_px=box32)
    return launches, summary


def step_breakdown(eng, host_batch, resized: bool):
    """Where a full-frame step's time goes: the upload of ``host_batch``
    (pageable, host clock, synchronised) and the device step on the
    resident batch (CUDA events, mean of 3)."""
    t0 = time.perf_counter()
    x = torch.from_numpy(host_batch).cuda()
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    with torch.inference_mode():
        device_ms = cuda_ms(lambda: eng._step(x, resized), iters=3, warmup=1)
    return dict(upload_mb=host_batch.nbytes / 1e6, upload_ms=upload_ms,
                device_step_ms=device_ms)


def top5_agreement(a, b):
    """Frames (or clips) whose top-5 classes are equal in order, frames
    whose top-1 is equal, and the largest score delta."""
    (sa, ca), (sb, cb) = a, b
    return (int((ca == cb).all(axis=1).sum()), int((ca[:, 0] == cb[:, 0]).sum()),
            float(np.abs(sa - sb).max()))


def resnet_config(**over):
    from realtime_analytics_tpu_torch.config import DetectorConfig

    kw = dict(model_type="resnet", model_path="resnet50-chip-smoke-seeded", device="cuda",
              input_size=[224, 224], resnet_num_classes=1000, resnet_top_k=5,
              confidence_threshold=1e-6, max_batch_size=N, batch_buckets=[N],
              warmup=False, host_resize="off", precision="bf16")
    kw.update(over)
    return DetectorConfig(**kw)


def run_resnet(params, frames):
    """ResNet-50 on full 1080p frames: B4 stretch to 224x224 fp32, then
    normalize and the forward; bf16 and fp32; top-5 against
    ``pallas_preprocess: off`` (the unrounded bilinear resize)."""
    from realtime_analytics_tpu_torch.engine.detector import TorchResNetEngine
    from realtime_analytics_tpu_torch.ops import _cuda

    out, paths = {}, {}
    for prec in ("bf16", "fp32"):
        eng = TorchResNetEngine(resnet_config(precision=prec), params=params)
        eng.classify(frames)
        torch.cuda.synchronize()
        _cuda.LAUNCHES.reset()
        got = eng.classify(frames)
        paths[f"resnet_{prec}"] = launches = _cuda.LAUNCHES.snapshot()
        require_launched(f"ResNet-50 {prec} path", launches, ("letterbox",))
        assert got[0].shape == (N, 5) and np.isfinite(got[0]).all()
        off = TorchResNetEngine(resnet_config(precision=prec, pallas_preprocess="off"),
                                params=params)
        top5, top1, score_d = top5_agreement(got, off.classify(frames))
        log(f"ResNet-50 {prec}, B4 on vs off: top-5 equal on {top5}/{N} frames, top-1 on "
            f"{top1}/{N}, max |raw score| delta {score_d:.4g}")
        if prec == "fp32":
            # B4 rounds to uint8 levels, the off path does not: the inputs
            # differ by at most half a level (0.0087 after normalizing)
            assert top5 == N and score_d <= 0.05, "ResNet-50 fp32 top-5 disagree"
        del off
        torch.cuda.reset_peak_memory_stats()
        step_ms, step_min = timed_ms(lambda: eng.classify(frames), 5)
        out[prec] = dict(step_ms_median=step_ms, step_ms_min=step_min,
                         frames_per_s=N / step_ms * 1e3,
                         max_memory_allocated_mib=torch.cuda.max_memory_allocated() / 2**20,
                         top5_equal_frames=top5, top1_equal_frames=top1,
                         max_score_delta=score_d, **step_breakdown(eng, frames, False))
        del eng
    host = TorchResNetEngine(resnet_config(host_resize="on"), params=params)
    host.classify(frames)
    step_ms, step_min = timed_ms(lambda: host.classify(frames), 3)
    out["bf16_host_resize_on"] = dict(step_ms_median=step_ms, step_ms_min=step_min,
                                      frames_per_s=N / step_ms * 1e3)
    return paths, out


def run_temporal(frames):
    """Each temporal family on 4 clips of 16 full 1080p frames: B4 stretch
    of the 64 frames, normalize, the clip forward; top-5 against
    ``pallas_preprocess: off`` (reported: that is the unrounded resize, a
    different function; B4 itself is held at these shapes in phase 3)."""
    from realtime_analytics_tpu_torch.config import DetectorConfig, StreamConfig
    from realtime_analytics_tpu_torch.engine.temporal import TorchTemporalEngine
    from realtime_analytics_tpu_torch.models.temporal import build_temporal
    from realtime_analytics_tpu_torch.models.weights import temporal_synthetic_params
    from realtime_analytics_tpu_torch.ops import _cuda
    from realtime_analytics_tpu_torch.types import FramePacket

    t_len, clips = 16, 4
    seqs = [[FramePacket(stream=StreamConfig(name=f"cam-{c}", url="synthetic://"),
                         frame=frames[(c * t_len + t) % len(frames)], frame_id=t,
                         timestamp=t / 25.0) for t in range(t_len)] for c in range(clips)]
    out, paths = {}, {}
    for family, hw in (("cnn_lstm", 224), ("conv_gru", 224), ("3d_cnn", 112),
                       ("slow_fast", 112)):
        params = temporal_synthetic_params(build_temporal(family, 400), seed=0)

        def cfg(**over):
            kw = dict(model_type=family, model_path=f"{family}-chip-smoke-seeded",
                      device="cuda", input_size=[hw, hw], num_action_classes=400,
                      sequence_length=t_len, batch_buckets=[clips], max_batch_size=clips,
                      host_resize="off", warmup=False, confidence_threshold=1e-6)
            kw.update(over)
            return DetectorConfig(**kw)

        eng = TorchTemporalEngine(cfg(), params=params)
        eng.predict_clips(seqs)
        torch.cuda.synchronize()
        _cuda.LAUNCHES.reset()
        got = eng.predict_clips(seqs)
        paths[family] = launches = _cuda.LAUNCHES.snapshot()
        require_launched(f"{family} clip path", launches, ("letterbox",))
        want = TorchTemporalEngine(cfg(pallas_preprocess="off"), params=params).predict_clips(seqs)

        def arrays(dets):
            return (np.array([[d.confidence for d in c] for c in dets]),
                    np.array([[d.class_id for d in c] for c in dets]))

        assert all(len(c) == 5 for c in got), "a clip lost its top-5"
        top5, top1, score_d = top5_agreement(arrays(got), arrays(want))
        step_ms, step_min = timed_ms(lambda: eng.predict_clips(seqs), 3)
        t0 = time.perf_counter()
        stacked = np.stack([np.stack([p.frame for p in s]) for s in seqs])
        stack_ms = (time.perf_counter() - t0) * 1e3
        out[family] = dict(input=hw, launches=launches["letterbox"],
                           clip_step_ms_median=step_ms, clip_step_ms_min=step_min,
                           top5_equal_clips=top5, top1_equal_clips=top1,
                           max_prob_delta=score_d, stack_ms=stack_ms,
                           **step_breakdown(eng, stacked, False))
        del stacked
        log(f"{family} ({hw}x{hw}, bf16): launches {launches['letterbox']}, top-5 equal on "
            f"{top5}/{clips} clips against B4 off (reported), clip step {step_ms:.1f} ms")
        del eng
    return paths, out


# ---------------------------------------------------------------------------
# phase 11: generic ONNX-graph serving (B4 and B1)
# ---------------------------------------------------------------------------


def resnet_to_onnx(tree, path: str, hw: int) -> None:
    """A ResNet-50 params tree (HWIO, BN folded) as a plain classifier ONNX
    graph, written with ``onnx_lite.write_onnx_model``: input ``images``
    [N, 3, hw, hw], output ``logits``. Matches no checkpoint layout, so the
    engine serves it as a graph."""
    from realtime_analytics_tpu_torch.models.onnx_lite import (
        OnnxGraph,
        OnnxNode,
        write_onnx_model,
    )

    nodes, inits = [], {}

    def conv(x, p, k, s, name):
        inits[f"{name}.w"] = np.ascontiguousarray(np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1))
        inits[f"{name}.b"] = np.asarray(p["b"], np.float32)
        nodes.append(OnnxNode("Conv", [x, f"{name}.w", f"{name}.b"], [name],
                              attrs={"strides": [s, s], "pads": [k // 2] * 4}))
        return name

    def relu(x):
        nodes.append(OnnxNode("Relu", [x], [f"{x}.relu"]))
        return f"{x}.relu"

    y = relu(conv("images", tree["stem"], 7, 2, "stem"))
    nodes.append(OnnxNode("MaxPool", [y], ["pool"], attrs={
        "kernel_shape": [3, 3], "strides": [2, 2], "pads": [1, 1, 1, 1]}))
    y = "pool"
    for si, blocks in enumerate(tree["layers"]):
        for bi, blk in enumerate(blocks):
            s = 2 if si > 0 and bi == 0 else 1
            n = f"l{si}.{bi}"
            h = relu(conv(y, blk["conv1"], 1, 1, f"{n}.c1"))
            h = relu(conv(h, blk["conv2"], 3, s, f"{n}.c2"))
            h = conv(h, blk["conv3"], 1, 1, f"{n}.c3")
            ident = conv(y, blk["down"], 1, s, f"{n}.down") if blk.get("down") else y
            nodes.append(OnnxNode("Add", [h, ident], [f"{n}.sum"]))
            y = relu(f"{n}.sum")
    nodes.append(OnnxNode("GlobalAveragePool", [y], ["gap"]))
    nodes.append(OnnxNode("Flatten", ["gap"], ["flat"], attrs={"axis": 1}))
    inits["fc.w"] = np.asarray(tree["fc"]["w"], np.float32)
    inits["fc.b"] = np.asarray(tree["fc"]["b"], np.float32)
    nodes.append(OnnxNode("Gemm", ["flat", "fc.w", "fc.b"], ["logits"]))
    write_onnx_model(path, OnnxGraph(nodes=nodes, initializers=inits, inputs=["images"],
                                     outputs=["logits"]),
                     value_infos={"images": (np.float32, ("N", 3, hw, hw)),
                                  "logits": (np.float32, ("N", inits["fc.b"].shape[0]))})


def static_batch_copy(src: str, dst: str) -> int:
    """The graph with every Reshape target's 0 (copy-the-batch) dim set to
    1: batch 1 baked in, as a stock static Ultralytics export. Returns the
    number of targets changed."""
    from realtime_analytics_tpu_torch.models.onnx_lite import read_onnx_model, write_onnx_model

    g = read_onnx_model(src)
    targets = {n.inputs[1] for n in g.nodes if n.op_type == "Reshape"}
    for name in targets:
        t = g.initializers[name].copy()
        t[t == 0] = 1
        g.initializers[name] = t
    write_onnx_model(dst, g)
    return len(targets)


def paired(res, ref, swap_px: float):
    """Detections of two engines after NMS, frame by frame: the frames whose
    counts or class multisets differ; over the others, each detection paired
    with the nearest box of its class on the other side, the largest score
    and box differences, except near-tie swaps (scores equal to 1e-6, boxes
    more than ``swap_px`` apart: NMS took another of two tied candidates),
    which are counted."""
    differ, swaps, score_d, box_d = [], 0, 0.0, 0.0
    for i in range(len(res.num_valid)):
        n = int(res.num_valid[i])
        ca, cb = res.class_ids[i, :n], ref.class_ids[i, :n]
        if n != int(ref.num_valid[i]) or not np.array_equal(np.sort(ca), np.sort(cb)):
            differ.append(i)
            continue
        free = list(range(n))
        for j in range(n):
            k = min((f for f in free if cb[f] == ca[j]), key=lambda f: float(
                np.abs(res.boxes_xyxy[i, j] - ref.boxes_xyxy[i, f]).max()))
            free.remove(k)
            ds = abs(float(res.scores[i, j]) - float(ref.scores[i, k]))
            db = float(np.abs(res.boxes_xyxy[i, j] - ref.boxes_xyxy[i, k]).max())
            if db > swap_px and ds <= 1e-6:
                swaps += 1
                continue
            score_d, box_d = max(score_d, ds), max(box_d, db)
    return differ, swaps, score_d, box_d


def hold_against_native(eng, native, frames, res):
    """The graph engine against the native fp32 engine on the same tree.
    Before NMS, on the same pixels (the graph on the device letterbox, the
    native model on the host pick with its stem-folded weights): conf
    within 1e-4, boxes within 1e-2 px, classes agreeing on >= 0.999 of the
    anchors. After NMS, frame by frame: equal counts and class multisets,
    each detection paired with the nearest box of its class on the other
    side, scores within 1e-3 and boxes within 0.5 px, except a near-tie
    swap: a pair whose scores are equal to 1e-6 with boxes apart. The
    seeded model scores every anchor 0.5-0.61, so all 8400 pass conf 0.25
    and the 512 candidates NMS takes (``pre_nms_topk``) are cut among
    scores equal to 1e-6: at the cut, the two models' last-bit differences
    hand NMS different candidates. Swaps are counted and reported; the
    model outputs above hold every anchor."""
    from realtime_analytics_tpu_torch.ops.preprocess import letterbox_spec

    spec = letterbox_spec(frames.shape[1:3], eng.input_hw)
    with torch.inference_mode():
        got = eng.model(eng._device_letterbox(torch.from_numpy(frames).cuda(), spec),
                        reduce_scores=True)
    want = model_outputs(native, frames)
    conf_d = (got["conf"] - want["conf"]).abs().max().item()
    box_d = (got["boxes_xyxy"] - want["boxes_xyxy"]).abs().max().item()
    cls_agree = (got["cls"] == want["cls"]).float().mean().item()
    passing = (want["conf"] >= eng.config.confidence_threshold).sum(1).float().mean().item()
    del got, want
    differ, swaps, score_d, box_d_nms = paired(res, native.predict_arrays(frames), 0.5)
    same = N - len(differ)
    log(f"onnx graph fp32 against the native fp32 engine: model outputs max |conf| delta "
        f"{conf_d:.3g} (<= 1e-4), max |box| delta {box_d:.3g} px (<= 1e-2), class agreement "
        f"{cls_agree:.5f} (>= 0.999), {passing:.0f} anchors a frame pass the threshold; "
        f"detections: {same}/{N} frames with equal counts and classes, max |score| delta "
        f"{score_d:.3g} (tol 1e-3), max |box| delta {box_d_nms:.3g} px (tol 0.5), "
        f"{swaps} near-tie swap(s)")
    assert conf_d <= 1e-4 and box_d <= 1e-2 and cls_agree >= 0.999, "graph outputs drift"
    assert same == N and score_d <= 1e-3 and box_d_nms <= 0.5, "graph detections differ"
    return dict(model_conf_max_delta=conf_d, model_box_max_delta_px=box_d,
                model_class_agreement=cls_agree, anchors_passing_mean=passing,
                frames_equal=same, score_max_delta=score_d, box_max_delta_px=box_d_nms,
                tie_swaps=swaps)


def check_int_ops():
    """The integer ops on single-node graphs on the card, bit-equal to the
    numpy oracle (``onnx_exec.run_graph``, int64 arithmetic), with zero
    points and uint8 operands."""
    from realtime_analytics_tpu_torch.models.onnx_exec import run_graph
    from realtime_analytics_tpu_torch.models.onnx_lite import OnnxGraph, OnnxNode
    from realtime_analytics_tpu_torch.models.onnx_torch import compile_graph

    rng = np.random.default_rng(6)

    def i8(*shape, dtype=np.int8):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max + 1, shape).astype(dtype)

    xq, a, b = i8(4, 32, 40, 40, dtype=np.uint8), i8(512, 256, dtype=np.uint8), i8(256, 384)
    cases = {
        "ConvInteger": ("ConvInteger", ["x", "w", "xz", "wz"],
                        {"w": i8(64, 32, 3, 3), "xz": np.array(117, np.uint8),
                         "wz": np.array(3, np.int8)}, {"pads": [1, 1, 1, 1]}, xq),
        "MatMulInteger": ("MatMulInteger", ["x", "b", "az", "bz"],
                          {"b": b, "az": np.array(131, np.uint8),
                           "bz": rng.integers(-4, 5, 384).astype(np.int8)}, {}, a),
        "QLinearConv": ("QLinearConv", ["x", "xs", "xz", "w", "ws", "wz", "ys", "yz", "bias"],
                        {"xs": np.array(0.02, np.float32), "xz": np.array(117, np.uint8),
                         "w": i8(64, 32, 3, 3),
                         "ws": rng.uniform(0.001, 0.01, 64).astype(np.float32),
                         "wz": np.zeros(64, np.int8), "ys": np.array(0.5, np.float32),
                         "yz": np.array(128, np.uint8),
                         "bias": rng.integers(-2000, 2000, 64).astype(np.int32)},
                        {"pads": [1, 1, 1, 1], "strides": [2, 2]}, xq),
        "QLinearMatMul": ("QLinearMatMul", ["x", "as", "az", "b", "bs", "bz", "ys", "yz"],
                          {"as": np.array(0.02, np.float32), "az": np.array(131, np.uint8),
                           "b": b, "bs": np.array(0.01, np.float32),
                           "bz": np.array(0, np.int8), "ys": np.array(2.0, np.float32),
                           "yz": np.array(-3, np.int8)}, {}, a),
        "DequantizeLinear": ("DequantizeLinear", ["x", "s", "z"],
                             {"s": rng.uniform(0.01, 0.1, 32).astype(np.float32),
                              "z": rng.integers(100, 150, 32).astype(np.uint8)},
                             {"axis": 1}, xq),
    }
    out = {}
    for name, (op, ins, inits, attrs, x) in cases.items():
        g = OnnxGraph(nodes=[OnnxNode(op, ins, ["y"], attrs=attrs)], initializers=inits,
                      inputs=["x"], outputs=["y"])
        with torch.inference_mode():
            (got,) = compile_graph(g)({"x": torch.from_numpy(x).cuda()})
            torch.cuda.synchronize()
        (want,) = run_graph(g, {"x": x})
        got = got.cpu().numpy()
        equal = got.shape == want.shape and np.array_equal(got, want)
        out[name] = dict(x=list(x.shape), out=list(want.shape), dtype=str(want.dtype),
                         bit_equal=bool(equal))
        log(f"onnx int op {name}: x {list(x.shape)} -> {list(want.shape)} {want.dtype}, "
            f"bit-equal to the numpy oracle: {equal}")
        assert equal, f"integer op {name} differs from the oracle on the card"
    return out


def run_onnx(params, frames, resnet_params):
    """Generic ONNX-graph serving: the seeded YOLOv8n written by the port's
    ``yolo_to_onnx`` (input ``images`` [N, 3, 640, 640], output ``output0``
    [N, 84, 8400]) served through ``create_detector`` on 32 x 1080p at fp32
    (full frames: B4 ``select`` once a step, B1 twice, no B2 or B3), held
    against the native fp32 engine on the same tree and against the same
    engine with B4 and B1 off; at ``graph_precision: bf16``; a static-batch
    copy through ``torch.func.vmap``; a ResNet-50 classifier graph (B4
    ``stretch``) against the native engine; the integer ops."""
    from realtime_analytics_tpu_torch.engine.detector import (
        TorchResNetEngine,
        TorchYoloEngine,
        create_detector,
    )
    from realtime_analytics_tpu_torch.models.onnx_export import yolo_to_onnx
    from realtime_analytics_tpu_torch.models.onnx_lite import read_onnx_model
    from realtime_analytics_tpu_torch.models.yolo import build_yolo
    from realtime_analytics_tpu_torch.ops import _cuda
    from realtime_analytics_tpu_torch.ops.preprocess import letterbox_spec

    wdir = ROOT / "build" / "chip_smoke"
    wdir.mkdir(parents=True, exist_ok=True)
    path = str(wdir / "yolov8n_seeded.onnx")
    t0 = time.perf_counter()
    yolo_to_onnx(build_yolo("yolov8", "n", 80), params, path, (HW, HW))
    export_s = time.perf_counter() - t0
    n_nodes = len(read_onnx_model(path).nodes)
    paths, out = {}, dict(export_s=export_s, graph_nodes=n_nodes)

    def cfg(**over):
        return detector_config(model_path=path, precision="fp32", confidence_threshold=ONNX_CONF,
                               **over)

    def step_launches(eng, name, kernels):
        eng.predict_arrays(frames)  # plans the graph at this shape, cuDNN choices
        torch.cuda.synchronize()
        _cuda.LAUNCHES.reset()
        res = eng.predict_arrays(frames)
        paths[name] = launches = _cuda.LAUNCHES.snapshot()
        log(f"{name} path launches {json.dumps(launches)}")
        for k, want in kernels.items():
            assert launches[k] == want, f"{name}: {k} launched {launches[k]} times, not {want}"
        assert res.boxes_xyxy.shape == (N, 300, 4) and np.isfinite(res.boxes_xyxy).all()
        assert np.isfinite(res.scores).all() and (res.num_valid > 0).all()
        return res

    t0 = time.perf_counter()
    eng = create_detector(cfg())
    out["engine_build_s"] = time.perf_counter() - t0
    assert eng.model.graph_backed and eng.model.dynamic_batch
    assert eng.compute_dtype == torch.float32
    assert not eng.host_prepare(frames, frames.shape[1:3])[1], "the graph path takes full frames"
    path_kernels = {"letterbox": 1, "row_gather": 2, "decode_v8": 0, "fused_stem": 0,
                    "nms_keep": 1}
    res = step_launches(eng, "onnx_yolo", path_kernels)
    log(f"onnx_yolo num_valid per frame {res.num_valid.tolist()}")
    native = TorchYoloEngine(detector_config(precision="fp32", confidence_threshold=ONNX_CONF),
                             params=params)
    native_out = hold_against_native(eng, native, frames, res)
    del native
    off = create_detector(cfg(pallas_preprocess="off", pallas_gather="off"))
    off.predict_arrays(frames)
    _cuda.LAUNCHES.reset()
    res_off = off.predict_arrays(frames)
    # B6 has no knob (NMS's keep pass is the kernel on the card); the other
    # kernels stay off
    assert _cuda.LAUNCHES.snapshot() == dict(row_gather=0, decode_v8=0, fused_stem=0,
                                             letterbox=0, nms_keep=1), \
        "kernels launched with B4 and B1 off"
    _, off_score, off_box = hold("onnx graph fp32, B4 + B1 on against off", res, res_off,
                                 score_tol=1e-5, box_tol=1e-3)
    del off

    # where a step's time goes: the upload of 32 full frames (pageable), the
    # device step on resident frames, the host's cost of the graph alone
    # planned and unplanned (once each, unsynchronised: the enqueue), and
    # the plan's op count against the graph's nodes
    spec = letterbox_spec(frames.shape[1:3], eng.input_hw)
    step_ms, step_min = timed_ms(lambda: eng.predict_arrays(frames), 10)
    t0 = time.perf_counter()
    resident = torch.from_numpy(frames).cuda()
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    with torch.inference_mode():
        device_ms = cuda_ms(lambda: eng._step_device_resize(resident, spec), iters=5, warmup=1)
        xg = eng._device_letterbox(resident, spec).permute(0, 3, 1, 2)
        feeds = {eng.model.input_name: xg, **eng.model.params()}
        fn = eng.model._fn
        fn(feeds)
        torch.cuda.synchronize()
        host = {}
        for label, call in (("planned", fn), ("unplanned", fn.unplanned)):
            t0 = time.perf_counter()
            call(feeds)
            host[f"{label}_host_ms"] = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            host[f"{label}_synced_ms"] = (time.perf_counter() - t0) * 1e3
        plan = fn.plan_for(feeds)
        del xg, feeds
    out["yolo_fp32"] = dict(
        step_ms_median=step_ms, step_ms_min=step_min, frames_per_s=N / step_ms * 1e3,
        upload_mb=frames.nbytes / 1e6, upload_ms=upload_ms, device_step_ms=device_ms,
        plan_ops=len(plan.steps), folded_graph_nodes=len(eng.model.graph.nodes), **host,
        num_valid_mean=float(res.num_valid.mean()), native=native_out,
        kernels_off_score_max_delta=off_score,
        kernels_off_box_max_delta_px=off_box)
    log("onnx_yolo fp32 " + json.dumps(out["yolo_fp32"]))

    # graph_precision: bf16 — model outputs and detections against fp32
    eng16 = create_detector(cfg(graph_precision="bf16"))
    assert eng16.compute_dtype == torch.bfloat16
    res16 = step_launches(eng16, "onnx_yolo_bf16", path_kernels)
    with torch.inference_mode():
        got = eng16.model(eng16._device_letterbox(resident, spec), reduce_scores=True)
        want = eng.model(eng._device_letterbox(resident, spec), reduce_scores=True)
    conf_d = (got["conf"].float() - want["conf"]).abs().max().item()
    box_med = (got["boxes_xyxy"].float() - want["boxes_xyxy"]).abs().median().item()
    cls_agree = (got["cls"] == want["cls"]).float().mean().item()
    hits = [matched(res16, res, i, 300, 0.05) for i in range(N)]
    share = sum(h for h, _ in hits) / max(1, sum(k for _, k in hits))
    step16, step16_min = timed_ms(lambda: eng16.predict_arrays(frames), 10)
    out["yolo_bf16"] = dict(step_ms_median=step16, step_ms_min=step16_min,
                            conf_max_delta_vs_fp32=conf_d, box_median_delta_vs_fp32_px=box_med,
                            class_agreement_vs_fp32=cls_agree,
                            detections_matched_share_vs_fp32=share,
                            num_valid_mean=float(res16.num_valid.mean()))
    log("onnx_yolo bf16 " + json.dumps(out["yolo_bf16"]))
    del eng16, got, want

    # a static-batch copy (batch 1 baked into every Reshape) through vmap
    static_path = str(wdir / "yolov8n_seeded_static.onnx")
    changed = static_batch_copy(path, static_path)
    eng_s = create_detector(detector_config(model_path=static_path, precision="fp32",
                                            confidence_threshold=ONNX_CONF))
    assert not eng_s.model.dynamic_batch, "the static copy must serve through vmap"
    with torch.inference_mode():
        x = eng._device_letterbox(resident, spec)
        a, b = eng_s.model(x, reduce_scores=True), eng.model(x, reduce_scores=True)
        conf_s = (a["conf"] - b["conf"]).abs().max().item()
        box_s = ((a["boxes_xyxy"] - b["boxes_xyxy"]).abs()
                 / b["boxes_xyxy"].abs().clamp_min(1.0)).max().item()
        cls_s = bool(torch.equal(a["cls"], b["cls"]))
        vmap_ms = cuda_ms(lambda: eng_s.model(x, reduce_scores=True), iters=3, warmup=1)
        direct_ms = cuda_ms(lambda: eng.model(x, reduce_scores=True), iters=3, warmup=1)
    log(f"onnx static-batch copy ({changed} Reshape targets) through vmap against the dynamic "
        f"graph: max |conf| delta {conf_s:.3g} (<= 1e-4), max relative box delta {box_s:.3g} "
        f"(<= 1e-4), classes equal {cls_s}; {vmap_ms:.2f} ms against {direct_ms:.2f} ms")
    assert conf_s <= 1e-4 and box_s <= 1e-4 and cls_s, "vmap over the static copy differs"
    out["static_vmap"] = dict(reshape_targets=changed, conf_max_delta=conf_s,
                              box_max_rel_delta=box_s, classes_equal=cls_s,
                              model_ms=vmap_ms, dynamic_model_ms=direct_ms)
    del eng_s, x, a, b, resident, eng
    torch.cuda.empty_cache()

    # a ResNet-50 classifier graph (B4 stretch) against the native engine
    rpath = str(wdir / "resnet50_seeded.onnx")
    resnet_to_onnx(resnet_params, rpath, 224)
    reng = TorchResNetEngine(resnet_config(model_path=rpath, precision="fp32"))
    assert reng.model.graph_backed and reng.compute_dtype == torch.float32
    reng.classify(frames)
    torch.cuda.synchronize()
    _cuda.LAUNCHES.reset()
    got = reng.classify(frames)
    paths["onnx_resnet"] = launches = _cuda.LAUNCHES.snapshot()
    log(f"onnx_resnet path launches {json.dumps(launches)}")
    assert launches["letterbox"] == 1, "the classifier graph must run B4's stretch once a step"
    nat = TorchResNetEngine(resnet_config(precision="fp32"), params=resnet_params)
    top5, top1, score_d = top5_agreement(got, nat.classify(frames))
    log(f"onnx ResNet-50 graph against the native engine, fp32: top-5 equal on {top5}/{N} "
        f"frames, top-1 on {top1}/{N}, max |logit| delta {score_d:.3g}")
    assert top5 == N, "the ResNet-50 graph's top-5 differs from the native engine's"
    rstep, rstep_min = timed_ms(lambda: reng.classify(frames), 5)
    out["resnet50_graph"] = dict(top5_equal_frames=top5, top1_equal_frames=top1,
                                 logit_max_delta=score_d, step_ms_median=rstep,
                                 step_ms_min=rstep_min)
    del reng, nat
    out["int_ops"] = check_int_ops()
    torch.cuda.empty_cache()
    return paths, out


# ---------------------------------------------------------------------------
# phase 12: serving artifacts
# ---------------------------------------------------------------------------


def run_artifact(params, frames, frames720, resnet_params):
    """Serving artifacts: each engine exported on the card into a ``.rvae``
    (``engine/export.py``), then built from the file alone through
    ``create_detector``. For the main path (bf16 ``sel``), the device-resize
    step (``full``), int8 (its calibrated scales from the file), YOLOv5n,
    ResNet-50 ``full``, CNN-LSTM ``full`` and the YOLOv8n ONNX graph: the
    exported engine's results equal to the live engine's on the same
    inputs, bit for bit; the launches of one replayed step by path
    (``rvae_*``: every kernel a node of the program, none decomposed or
    replaced); export seconds and artifact bytes; startup (load + warmup of
    the exported engine against building the live engine from its
    checkpoint + warmup); the exported step's time against the live one's."""
    import os

    from realtime_analytics_tpu_torch.config import DetectorConfig, StreamConfig
    from realtime_analytics_tpu_torch.engine.detector import create_detector
    from realtime_analytics_tpu_torch.engine.export import export_serving_artifact
    from realtime_analytics_tpu_torch.models.onnx_export import yolo_to_onnx
    from realtime_analytics_tpu_torch.models.temporal import build_temporal
    from realtime_analytics_tpu_torch.models.weights import (
        synthetic_params,
        temporal_synthetic_params,
    )
    from realtime_analytics_tpu_torch.models.yolo import build_yolo
    from realtime_analytics_tpu_torch.ops import _cuda
    from realtime_analytics_tpu_torch.types import FramePacket

    wdir = ROOT / "build" / "chip_smoke"
    wdir.mkdir(parents=True, exist_ok=True)
    onnx_path = wdir / "yolov8n_seeded.onnx"
    if not onnx_path.exists():
        yolo_to_onnx(build_yolo("yolov8", "n", 80), params, str(onnx_path), (HW, HW))
    t_len, clips = 16, 4
    seqs = [[FramePacket(stream=StreamConfig(name=f"cam-{c}", url="synthetic://"),
                         frame=frames[(c * t_len + t) % len(frames)], frame_id=t,
                         timestamp=t / 25.0) for t in range(t_len)] for c in range(clips)]
    yolo_kernels = dict(row_gather=2, decode_v8=1, fused_stem=1, nms_keep=1, letterbox=0)
    temporal_cfg = dict(model_type="cnn_lstm", device="cuda", input_size=[224, 224],
                        num_action_classes=400, sequence_length=t_len, batch_buckets=[clips],
                        max_batch_size=clips, host_resize="off", warmup=False,
                        confidence_threshold=1e-6)
    cases = {
        # name: (config, inputs, source size, launches of one step)
        "main": (detector_config(model_path=saved_tree("yolov8n_seeded.npz", params)),
                 frames, yolo_kernels),
        "device_resize": (detector_config(model_path=saved_tree("yolov8n_seeded.npz", params),
                                          host_resize="off"),
                          frames720, dict(yolo_kernels, letterbox=1)),
        "int8": (detector_config(model_path=saved_tree("yolov8n_seeded.npz", params),
                                 precision="int8"),
                 frames, dict(yolo_kernels, fused_stem=0)),
        "yolov5": (detector_config(model_type="yolov5", model_path=saved_tree(
                       "yolov5n_seeded.npz", synthetic_params(build_yolo("yolov5", "n", 80),
                                                              seed=0))),
                   frames, dict(yolo_kernels, decode_v8=0, fused_stem=0)),
        "resnet": (resnet_config(model_path=saved_tree("resnet50_seeded.npz", resnet_params)),
                   frames, dict(letterbox=1)),
        "temporal": (DetectorConfig(**temporal_cfg, model_path=saved_tree(
                         "cnn_lstm_seeded.npz",
                         temporal_synthetic_params(build_temporal("cnn_lstm", 400), seed=0))),
                     seqs, dict(letterbox=1)),
        "onnx_yolo": (detector_config(model_path=str(onnx_path), precision="fp32",
                                      confidence_threshold=ONNX_CONF),
                      frames, dict(yolo_kernels, decode_v8=0, fused_stem=0, letterbox=1)),
    }

    def predict(eng, inputs):
        if isinstance(inputs, list):  # clips
            dets = eng.predict_clips(inputs)
            return [np.array([[d.confidence for d in c] for c in dets]),
                    np.array([[d.class_id for d in c] for c in dets])]
        if eng.config.model_type == "resnet":
            return list(eng.classify(inputs))
        res = eng.predict_arrays(inputs)
        return [res.boxes_xyxy, res.scores, res.class_ids, res.num_valid]

    paths, out = {}, {}
    for name, (cfg, inputs, kernels) in cases.items():
        src_hw = tuple((inputs[0][0].frame if isinstance(inputs, list) else inputs[0]).shape[:2])
        rvae = str(wdir / f"{name}.rvae")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        live = create_detector(cfg)
        live.warmup(src_hw)
        torch.cuda.synchronize()
        live_start_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        meta = export_serving_artifact(live, rvae, [src_hw])
        export_s = time.perf_counter() - t0
        assert [p["batch"] for p in meta["programs"]] == [len(inputs)]
        t0 = time.perf_counter()
        eng = create_detector(dataclasses.replace(cfg, model_path=rvae))
        eng.warmup(src_hw)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        want = predict(live, inputs)
        torch.cuda.synchronize()
        _cuda.LAUNCHES.reset()
        got = predict(eng, inputs)
        paths[f"rvae_{name}"] = launches = _cuda.LAUNCHES.snapshot()
        require_counts(f"rvae_{name}", launches, kernels)
        equal = all(np.array_equal(a, b) for a, b in zip(got, want))
        live_ms, _ = timed_ms(lambda: predict(live, inputs), 5)
        step_ms, _ = timed_ms(lambda: predict(eng, inputs), 5)
        out[name] = dict(program=meta["programs"][0]["name"], export_s=export_s,
                         artifact_bytes=os.path.getsize(rvae), live_build_warmup_s=live_start_s,
                         load_warmup_s=load_s, live_step_ms=live_ms, step_ms=step_ms,
                         equal_to_live=equal, launches=launches)
        log(f"artifact {name}: " + json.dumps(dict(out[name], card=CARD)))
        assert equal, f"rvae_{name}: the exported engine's results differ from the live engine's"
        assert np.isfinite(got[0]).all()
        del live, eng
        torch.cuda.empty_cache()
    return paths, out


# ---------------------------------------------------------------------------
# phase 13: training and evaluation
# ---------------------------------------------------------------------------


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    """||got - want|| / ||want|| (0 when both are zero)."""
    diff = float(np.linalg.norm(got - want))
    return diff / max(float(np.linalg.norm(want)), 1e-30) if diff else 0.0


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def labeled_frames(n: int, hw):
    """``n`` labeled synthetic frames (4 boxes each, source seeds 0..n-1)
    and their ground truth."""
    from realtime_analytics_tpu_torch.ingest.synthetic import SyntheticSource

    frames, gts = [], []
    for i in range(n):
        ok, frame, gt, cls = SyntheticSource(width=hw[1], height=hw[0], boxes=4,
                                             seed=i).read_labeled()
        assert ok
        frames.append(frame)
        gts.append((np.asarray(gt, np.float32), np.asarray(cls, int)))
    return np.stack(frames), gts


def rows_of(res):
    """The valid detections of each frame of a result: (boxes, scores, classes)."""
    for i in range(len(res.num_valid)):
        n = int(res.num_valid[i])
        yield res.boxes_xyxy[i, :n], res.scores[i, :n], res.class_ids[i, :n].astype(int)


def map50(rows, gts) -> float:
    from realtime_analytics_tpu_torch.eval.detection_metrics import (
        DetectionSample,
        evaluate_detections,
    )

    samples = [DetectionSample(det_boxes=b, det_scores=sc, det_classes=c, gt_boxes=gt,
                               gt_classes=cls)
               for (b, sc, c), (gt, cls) in zip(rows, gts)]
    return evaluate_detections(samples)["map50"]


def trace_step(step_fn, state, images, targets, top=6):
    """One more train step under ``torch.profiler`` (CPU and CUDA): its wall
    ms, the card's busy ms (the kernels' device time, summed) and the
    ``top`` kernels by device time. The trace's own cost is in the wall
    time, so it is not the step's time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, loss = step_fn(state, images, targets)
        float(loss)
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    top_ms = {e.key[:80]: e.self_device_time_total / 1e3 for e in ranked}
    log(f"train step traced: wall {wall:.2f} ms, device busy {busy:.2f} ms over "
        f"{len(kernels)} kernel names; top {json.dumps(top_ms)}")
    return dict(traced_step_wall_ms=wall, traced_step_device_busy_ms=busy,
                traced_step_kernel_names=len(kernels), traced_step_top_kernels_ms=top_ms)


def hold_ties(eng, off, frames, res, res_off):
    """The fp32 engine with every kernel on against every kernel off, on
    the same weights. Before NMS, every anchor: conf within 1e-3 of its
    value plus 1e-6, boxes within 1e-2 px; an anchor's class may differ only
    where the kernels-off model's two largest class logits tie within 1e-6
    of their size (about 8 fp32 ulps: B2 and B3 round apart from the plain
    path, and a class flips only where two logits differ by less than
    that). After NMS, frame by frame (``paired``): equal counts and class
    multisets, scores within 1e-5 and boxes within 1e-2 px, except near-tie
    swaps. A model a few steps from its init scores thousands of anchors
    alike to 1e-7, so a frame's counts or classes may differ, but only
    where a tie explains it, and such frames are counted by their tie: a
    class flip at tied logits on an anchor that passes the threshold (its
    box can suppress, or not, other boxes), or a tie at the ``pre_nms_topk``
    cut (the kernels-off conf of the last candidate taken and the first left
    out within twice the frame's largest conf delta, so the two engines can
    take different candidates)."""
    cfg = eng.config
    got, want = model_outputs(eng, frames), model_outputs(off, frames)
    conf_d = (got["conf"] - want["conf"]).abs()
    conf_excess = (conf_d - (1e-3 * want["conf"] + 1e-6)).max().item()
    conf_med = want["conf"].median().item()
    box_d = (got["boxes_xyxy"] - want["boxes_xyxy"]).abs().max().item()
    flips = got["cls"] != want["cls"]  # [N, A]
    live_flip = (flips & (want["conf"] >= cfg.confidence_threshold)).any(dim=1).cpu().numpy()
    ranked = want["conf"].sort(dim=1, descending=True).values
    k = cfg.pre_nms_topk
    cut_tie = ((ranked[:, k - 1] - ranked[:, k] <= 2 * conf_d.max(dim=1).values)
               & (ranked[:, k] >= cfg.confidence_threshold)).cpu().numpy()
    del got, want, ranked
    scores = model_outputs(off, frames, reduce_scores=False)["scores"]
    top2 = torch.logit(scores.double().topk(2, dim=-1).values)  # [N, A, 2]
    del scores
    gap = ((top2[..., 0] - top2[..., 1]) / top2[..., 0].abs().clamp_min(1.0))[flips]
    n_flips, gap_max = int(flips.sum()), (gap.max().item() if gap.numel() else 0.0)
    log(f"train_eval fp32 model outputs, every kernel on vs off: max |conf| delta "
        f"{conf_d.max().item():.3g}, largest excess over 1e-3*conf + 1e-6 {conf_excess:.3g} "
        f"(<= 0), median conf {conf_med:.3g}; max |box| delta {box_d:.3g} px (<= 1e-2); "
        f"{n_flips} anchor(s) of another class, largest relative top-two logit gap there "
        f"{gap_max:.3g} (<= 1e-6)")
    assert conf_excess <= 0 and box_d <= 1e-2 and gap_max <= 1e-6, \
        "train_eval model outputs differ with the kernels off"
    differ, swaps, score_d, box_nms = paired(res, res_off, 0.5)
    why = {i: [name for name, hit in (("class_flip", live_flip[i]), ("topk_cut", cut_tie[i]))
               if hit] for i in differ}
    for i in differ:
        a = Counter(res.class_ids[i, :res.num_valid[i]].tolist())
        b = Counter(res_off.class_ids[i, :res_off.num_valid[i]].tolist())
        log(f"  frame {i}: {int(res.num_valid[i])} against {int(res_off.num_valid[i])} "
            f"detections, classes only on: {dict(a - b)}, only off: {dict(b - a)}; ties: "
            f"{why[i] or 'none'}")
    by_tie = {name: sum(name in w for w in why.values()) for name in ("class_flip", "topk_cut")}
    log(f"train_eval fp32 detections, every kernel on vs off: {len(res.num_valid) - len(differ)}"
        f"/{len(res.num_valid)} frames with equal counts and classes, max |score| delta "
        f"{score_d:.3g} (<= 1e-5), max |box| delta {box_nms:.3g} px (<= 1e-2), {swaps} near-tie "
        f"swap(s); {len(differ)} frame(s) differ, by tie {json.dumps(by_tie)}")
    assert all(why.values()) and score_d <= 1e-5 and box_nms <= 1e-2, \
        "train_eval detections differ with the kernels off"
    return dict(eval_model_conf_max_delta=conf_d.max().item(),
                eval_model_conf_max_excess=conf_excess, eval_model_conf_median=conf_med,
                eval_model_box_max_delta_px=box_d, eval_class_flips=n_flips,
                eval_class_flip_max_rel_gap=gap_max, eval_all_off_frames_differ=len(differ),
                eval_all_off_differ_by_tie=by_tie, eval_all_off_tie_swaps=swaps,
                eval_all_off_score_max_delta=score_d, eval_all_off_box_max_delta_px=box_nms)


def run_train(params):
    """Training and evaluation ("train"): (1) one YOLOv8n step at 640 (nc
    80, the seeded params, 2 labeled synthetic images): the loss and every
    gradient leaf on the card (TF32 off) against the port on the CPU; (2)
    ``make_train_step`` at 640, batch 16, 30 steps on ``synthetic_batch``
    of 16 sources at 1280x1280: no kernel launched (B2 and B3 have no
    backward), the last loss below the first, ms a step (device step and
    host batch apart), images/s, peak memory, and one more step traced
    (device time, top kernels); (3) the trained weights in a fp32
    ``TorchYoloEngine`` (bucket 16) on 16 labeled 1080p frames: B1 twice,
    B2, B3 and B6 once a step, model outputs and detections held against
    every kernel off (``hold_ties``), detections against B1 off (equal),
    map50 of both; (4) the train CLI's integration recipe (400 steps,
    64², nc 4) on the card: its checkpoint's map50 above a random init's;
    (5) the eval CLI on the full-width checkpoint (32 synthetic 1080p
    frames, batch 16): its JSON."""
    import contextlib
    import io

    from realtime_analytics_tpu_torch.config import DetectorConfig
    from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine
    from realtime_analytics_tpu_torch.ingest.synthetic import SyntheticSource
    from realtime_analytics_tpu_torch.models.weights import params_from_jax, params_to_tree
    from realtime_analytics_tpu_torch.models.yolo import build_yolo
    from realtime_analytics_tpu_torch.ops import _cuda
    from realtime_analytics_tpu_torch.parallel.train import (
        anchor_centers,
        detection_loss,
        make_train_step,
        named_tree,
        step_numerics,
    )
    from realtime_analytics_tpu_torch.scripts import eval_detections
    from realtime_analytics_tpu_torch.scripts import train as train_cli

    hw, batch, steps = (HW, HW), 16, 30
    out = {}

    # (1) one step's loss and gradients, card against CPU
    sources = [SyntheticSource(width=2 * HW, height=2 * HW, boxes=4, seed=i)
               for i in range(batch)]
    images, targets = train_cli.synthetic_batch(sources[:2], hw, 4)
    side = {}
    for dev in ("cuda", "cpu"):
        model = params_from_jax(build_yolo("yolov8", "n", 80), params)
        make_train_step(model, hw, device=dev)
        anchors = torch.from_numpy(anchor_centers(hw)).to(dev)
        tg = {k: torch.from_numpy(v).to(dev) for k, v in targets.items()}
        with step_numerics():
            loss = detection_loss(model, torch.from_numpy(images).to(dev), tg, anchors)
            loss.backward()
        grads = named_tree(model, {n: p.grad for n, p in model.named_parameters()})
        side[dev] = (float(loss.detach()), tree_leaves(grads))
        del model
    (loss_card, g_card), (loss_cpu, g_cpu) = side["cuda"], side["cpu"]
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    grad_rel = max(rel_l2(a, b) for a, b in zip(g_card, g_cpu))
    out.update(loss_card=loss_card, loss_cpu=loss_cpu, loss_rel_diff=loss_rel,
               grad_leaves=len(g_card), grad_max_rel_l2=grad_rel)
    log(f"train step card vs CPU: loss {loss_card:.7g} vs {loss_cpu:.7g}, rel {loss_rel:.3g} "
        f"(<= 1e-5); {len(g_card)} gradient leaves, max rel L2 {grad_rel:.3g} (<= 1e-3)")
    assert loss_rel <= 1e-5 and grad_rel <= 1e-3, "the card's train step disagrees with the CPU's"

    # (2) full-width training: 30 steps at batch 16, no kernel launched
    model = build_yolo("yolov8", "n", 80)
    init_fn, step_fn = make_train_step(model, hw, learning_rate=2e-3, device="cuda")
    state = init_fn(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.LAUNCHES.reset()
    losses, step_ms, host_ms = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        images, targets = train_cli.synthetic_batch(sources, hw, 4)
        t1 = time.perf_counter()
        state, loss = step_fn(state, images, targets)
        losses.append(float(loss))  # waits for the step
        t2 = time.perf_counter()
        host_ms.append((t1 - t0) * 1e3)
        step_ms.append((t2 - t1) * 1e3)
    train_launches = _cuda.LAUNCHES.snapshot()
    mem = torch.cuda.max_memory_allocated() / 2**20
    step_med = statistics.median(step_ms)
    out.update(batch=batch, steps=steps, first_loss=losses[0], last_loss=losses[-1],
               step_ms_median=step_med, step_ms_min=min(step_ms),
               host_batch_ms_median=statistics.median(host_ms),
               images_per_s=batch / step_med * 1e3,
               images_per_s_with_host_batch=batch / (step_med + statistics.median(host_ms)) * 1e3,
               max_memory_allocated_mib=mem, launches=train_launches)
    log(f"train 640 b{batch}: loss {losses[0]:.4f} -> {losses[-1]:.4f} over {steps} steps; "
        f"step {step_med:.2f} ms median, host batch {statistics.median(host_ms):.2f} ms; "
        f"launches {json.dumps(train_launches)}")
    assert all(v == 0 for v in train_launches.values()), "the train step launched a kernel"
    assert losses[-1] < losses[0], "the loss did not go down"
    tree = params_to_tree(model)
    ckpt = saved_tree("yolov8n_train640.npz", tree)
    out.update(trace_step(step_fn, state, *train_cli.synthetic_batch(sources, hw, 4)))
    del model, state, init_fn, step_fn
    torch.cuda.empty_cache()

    # (3) the trained weights served through the kernels, fp32, bucket 16
    frames, gts = labeled_frames(batch, (1080, 1920))
    cfg = dict(precision="fp32", max_batch_size=batch, batch_buckets=[batch],
               confidence_threshold=0.001)
    eng = TorchYoloEngine(detector_config(**cfg), params=tree)
    eng.predict_arrays(frames)
    torch.cuda.synchronize()
    _cuda.LAUNCHES.reset()
    res = eng.predict_arrays(frames)
    eval_launches = _cuda.LAUNCHES.snapshot()
    require_counts("train_eval", eval_launches,
                   {"row_gather": 2, "decode_v8": 1, "fused_stem": 1, "nms_keep": 1})
    assert np.isfinite(res.boxes_xyxy).all() and (res.num_valid > 0).all()
    off = TorchYoloEngine(detector_config(pallas_gather="off", pallas_decode="off",
                                          pallas_stem="off", **cfg), params=tree)
    res_off = off.predict_arrays(frames)
    out.update(hold_ties(eng, off, frames, res, res_off))
    # after NMS, B1 on against off with B2 and B3 on both sides: equal, as
    # B1 is exact
    b1_off = TorchYoloEngine(detector_config(pallas_gather="off", **cfg), params=tree)
    _, score_d, box_d = hold("train_eval fp32 detections, B1 on vs off (B2, B3 on in both)",
                             res, b1_off.predict_arrays(frames), score_tol=1e-5, box_tol=1e-3)
    out.update(eval_map50=map50(rows_of(res), gts),
               eval_map50_kernels_off=map50(rows_of(res_off), gts),
               eval_b1_score_max_delta=score_d, eval_b1_box_max_delta_px=box_d,
               eval_launches=eval_launches)
    del eng, off, b1_off
    torch.cuda.empty_cache()

    # (4) the integration recipe of tests/test_train_eval_integration.py
    recipe = str(ROOT / "build" / "chip_smoke" / "recipe64.npz")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main(["--steps", "400", "--batch", "4", "--nc", "4",
                             "--boxes-per-image", "2", "--input-size", "64", "64",
                             "--seed", "1", "--eval", "--log-every", "100", "--out", recipe])
    recipe_s = time.perf_counter() - t0
    log("train CLI recipe: " + " | ".join(buf.getvalue().strip().splitlines()))
    assert rc == 0

    def recipe_map(path):
        src = SyntheticSource(width=64, height=64, boxes=2, seed=7)
        frames64, gts64 = [], []
        for _ in range(12):
            ok, frame, gt, cls = src.read_labeled()
            assert ok
            frames64.append(frame[None])
            gts64.append((np.asarray(gt, np.float32), np.asarray(cls, int)))
        e = TorchYoloEngine(DetectorConfig(
            model_path=path, model_type="yolov8", num_classes=4, input_size=[64, 64],
            warmup=False, precision="fp32", max_batch_size=1, batch_buckets=[1],
            pre_nms_topk=64, max_detections=8, confidence_threshold=0.05, device="cuda"))
        return map50([next(rows_of(e.predict_arrays(f))) for f in frames64], gts64)

    trained, random_init = recipe_map(recipe), recipe_map("__random__.pt")
    out.update(recipe_s=recipe_s, recipe_map50=trained, random_init_map50=random_init)
    log(f"train CLI recipe map50 {trained:.4f} vs random init {random_init:.4f} "
        f"({recipe_s:.1f} s for 400 steps + evals)")
    assert trained > random_init, "the recipe's training did not lift map50"

    # (5) the eval CLI on the full-width checkpoint
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = eval_detections.main(["--model-path", ckpt, "--synthetic", "32",
                                   "--synthetic-hw", "1080", "1920", "--input-size",
                                   "640", "640", "--batch", "16", "--json"])
    assert rc == 0
    cli = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert cli["n_images"] == 32, cli
    out.update(eval_cli_n_images=cli["n_images"], eval_cli_map50=cli["map50"],
               eval_cli_n_detections=cli["n_detections"])
    return {"train": train_launches, "train_eval": eval_launches}, out


# ---------------------------------------------------------------------------
# phase 14: the pipelines
# ---------------------------------------------------------------------------


def pipeline_streams(n_streams: int, width: int = 1920, height: int = 1080):
    """The pipelines' pooled synthetic streams at 25 fps, as config dicts."""
    return [dict(name=f"cam-{i:02d}",
                 url=f"synthetic://?width={width}&height={height}&boxes=4&seed={i}&pool=10",
                 target_fps=25, warmup_seconds=0.0, batch_size=2, adaptive_fps=False)
            for i in range(n_streams)]


def run_pipeline(detector, n_streams: int, seconds: float):
    """``AnalyticsPipeline`` with ``n_streams`` pooled synthetic 1080p
    streams at 25 fps for about ``seconds``; the launch counters are set to
    0 just before and read just after."""
    from realtime_analytics_tpu_torch.config import (
        KafkaSinkConfig,
        PipelineConfig,
        PrometheusConfig,
        SnapshotConfig,
        StreamConfig,
        TrackerConfig,
    )
    from realtime_analytics_tpu_torch.ops import _cuda
    from realtime_analytics_tpu_torch.pipeline import AnalyticsPipeline

    cfg = PipelineConfig(
        streams=[StreamConfig(**s) for s in pipeline_streams(n_streams)],
        detector=detector,
        tracker=TrackerConfig(),
        kafka=KafkaSinkConfig(enabled=True, transport="memory"),
        prometheus=PrometheusConfig(enabled=False),
        snapshots=SnapshotConfig(enabled=False),
        batch_window_ms=4,
        stats_interval_seconds=3600,
    )
    pipeline = AnalyticsPipeline(cfg)
    _cuda.LAUNCHES.reset()
    t0 = time.perf_counter()
    asyncio.run(pipeline.run_for(seconds))
    wall = time.perf_counter() - t0
    launches = _cuda.LAUNCHES.snapshot()
    per_stream = [w.health.total_frames for w in pipeline.workers]
    stats = pipeline.batchers["__default__"].stats
    lat = sorted(t * 1e3 for w in pipeline.workers for t in w.health.recent_processing_times)
    out = dict(
        streams=len(per_stream), wall_s=wall, frames=sum(per_stream),
        min_frames_per_stream=min(per_stream), batches=stats.batches,
        avg_batch=stats.avg_batch_size, avg_infer_ms=stats.avg_infer_ms,
        shed=stats.shed, sink_messages=pipeline.kafka.messages_sent,
        latency_ms_p50=lat[len(lat) // 2] if lat else None,
        latency_ms_p99=lat[min(len(lat) - 1, int(len(lat) * 0.99))] if lat else None,
        latency_samples=len(lat), launches=launches,
    )
    assert min(per_stream) > 0, f"a stream processed no frames: {per_stream}"
    assert stats.frames > 0 and pipeline.kafka.messages_sent > 0
    return launches, out


def saved_tree(name: str, tree) -> str:
    """Seeded weights as a native params-tree .npz the pipeline loads."""
    wdir = ROOT / "build" / "chip_smoke"
    wdir.mkdir(parents=True, exist_ok=True)
    path = wdir / name
    np.savez(path, __pytree__=np.array(tree, dtype=object))
    return str(path)


# ---------------------------------------------------------------------------
# phase 15: the stream-sharding supervisor and the dashboard
# ---------------------------------------------------------------------------

SHARD_RUNS = ((2, 15.0), (4, 10.0))  # (K, seconds of the bus window)
TRACED_WINDOW = 4.0  # seconds of the K = 2 run under --torch-profile
SHARD_TOPIC = "analytics.events"
# the kernels every shard of the main path must launch, and the one it must not
SHARD_KERNELS = ("row_gather_kernel", "decode_v8_kernel", "stem_mma_kernel",
                 "nms_mask_kernel", "nms_chain_kernel")
SHARD_ABSENT = ("letterbox_kernel",)


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def card_usage():
    """The contexts on the card and its used memory (MiB), from
    ``nvidia-smi``. Inside a container it may list every process as pid 1
    with the memory of them all, so the phase counts the contexts its shards
    add, not their pids, and reads the memory they add from the card's
    total."""
    def query(*args):
        out = subprocess.run(["nvidia-smi", *args, "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60, check=True)
        return [line for line in out.stdout.splitlines() if line.strip()]

    contexts = len(query("--query-compute-apps=pid"))
    return contexts, int(query("--query-gpu=memory.used")[0])


def http_json(url: str):
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as resp:
        return json.loads(resp.read())


async def dashboard_window(bus_port: int, window: float, names):
    """The port's ``DashboardServer`` on the bus for ``window`` seconds with
    one WebSocket client on ``/ws``: the first message is the snapshot,
    events of every stream follow; ``/api/health`` and ``/api/snapshot``
    answer."""
    import websockets

    from realtime_analytics_tpu_torch.api.server import DashboardServer
    from realtime_analytics_tpu_torch.config import KafkaSinkConfig

    server = DashboardServer(
        KafkaSinkConfig(enabled=True, transport="eventbus",
                        bootstrap_servers=f"127.0.0.1:{bus_port}", topic=SHARD_TOPIC),
        host="127.0.0.1", port=0)
    await server.start()
    try:
        t0 = time.perf_counter()
        streams, events, first_event_s = Counter(), 0, None
        async with websockets.connect(f"ws://127.0.0.1:{server.port}/ws") as ws:
            first = json.loads(await asyncio.wait_for(ws.recv(), 10))
            assert first["type"] == "snapshot", f"first /ws message: {first['type']}"
            try:
                async with asyncio.timeout(window):
                    async for text in ws:
                        msg = json.loads(text)
                        assert msg["type"] == "event", msg["type"]
                        if first_event_s is None:
                            first_event_s = time.perf_counter() - t0
                        streams[msg["payload"]["stream"]] += 1
                        events += 1
            except TimeoutError:
                pass
        base = f"http://127.0.0.1:{server.port}"
        health = await asyncio.to_thread(http_json, base + "/api/health")
        snapshot = await asyncio.to_thread(http_json, base + "/api/snapshot")
    finally:
        await server.stop()
    missing = sorted(set(names) - set(streams))
    assert not missing, f"the dashboard pushed no event of {missing}"
    snap_streams = {e["stream"] for e in snapshot["events"]}
    assert health["status"] == "ok" and health["messages_consumed"] >= events > 0, health
    assert snap_streams == set(names), sorted(set(names) - snap_streams)
    return dict(ws_events=events, ws_streams=len(streams),
                ws_min_events_per_stream=min(streams.values()),
                first_event_s=first_event_s, health=health,
                snapshot_streams=len(snap_streams))


async def bus_window(bus_port: int, window: float, names, dashboard: bool):
    """Subscribe to the bus for ``window`` seconds and count each stream's
    events; read ``nvidia-smi`` half way; run the dashboard beside it."""
    from realtime_analytics_tpu_torch.sinks.eventbus import EventBusSubscriber

    sub = EventBusSubscriber("127.0.0.1", bus_port, SHARD_TOPIC)
    await sub.connect()
    dash = (asyncio.create_task(dashboard_window(bus_port, window, names))
            if dashboard else None)

    async def usage_half_way():
        await asyncio.sleep(window / 2)
        return await asyncio.to_thread(card_usage)

    usage = asyncio.create_task(usage_half_way())
    counts = Counter()
    t0 = time.perf_counter()
    try:
        async with asyncio.timeout(window):
            async for payload in sub.messages():
                if payload and "stream" in payload:
                    counts[payload["stream"]] += 1
    except TimeoutError:
        pass
    finally:
        await sub.close()
    seconds = time.perf_counter() - t0
    return counts, seconds, await usage, (await dash if dash else None)


def last_batcher_stats(log_text: str):
    """The last ``[batcher]`` stats line of a shard's log, as a dict."""
    lines = [line for line in log_text.splitlines() if "[batcher] " in line]
    if not lines:
        return None
    return ast.literal_eval(lines[-1].split("[batcher] ", 1)[1])["__default__"]


def trace_kernels(trace_dir: Path) -> Counter:
    """Device kernel launches of a shard's Chrome trace, by port kernel."""
    (path,) = trace_dir.glob("trace-*.json")
    events = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    from realtime_analytics_tpu_torch.scripts.profile_step import PORT_KERNELS

    return Counter({k: sum(k in n for n in names) for k in PORT_KERNELS})


def drive_shards(k: int, window: float, detector: dict, streams, traced=False,
                 dashboard=False):
    """``realtime-analytics-torch --shards K --broker`` as a user runs it:
    a subprocess of the port's CLI whose K shards share the card and publish
    to one event bus. Waits until every shard logs "Pipeline started",
    counts each stream's events on the bus for ``window`` seconds (the
    dashboard beside it when asked), checks that every shard holds a context
    on the card and logs its share of the streams, then SIGTERMs the
    supervisor, which must exit 0. ``traced`` adds ``--torch-profile`` and
    counts the port's kernels in each shard's trace."""
    import yaml

    wdir = ROOT / "build" / "chip_smoke" / f"shards_k{k}{'_traced' if traced else ''}"
    shutil.rmtree(wdir, ignore_errors=True)
    wdir.mkdir(parents=True)
    bus_port = free_port()
    cfg_path = wdir / "pipeline.yaml"
    cfg_path.write_text(yaml.safe_dump(dict(
        streams=streams, detector=detector,
        kafka=dict(enabled=True, transport="eventbus", topic=SHARD_TOPIC,
                   bootstrap_servers=f"127.0.0.1:{bus_port}", include_frames=False),
        prometheus=dict(enabled=False), snapshots=dict(enabled=False),
        batch_window_ms=4, stats_interval_seconds=5)))
    cmd = [sys.executable, "-m", "realtime_analytics_tpu_torch.scripts.run_pipeline",
           "--config", str(cfg_path), "--shards", str(k), "--broker",
           "--duration", "600", "--log-level", "INFO", "--log-file", str(wdir / "shard.log")]
    if traced:
        cmd += ["--torch-profile", str(wdir / "trace")]
    names = [s["name"] for s in streams]
    contexts_before, used_before = card_usage()
    out_path = wdir / "supervisor.log"
    t0 = time.perf_counter()
    with open(out_path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
                                start_new_session=True)
    try:
        while out_path.read_text(errors="replace").count("Pipeline started") < k:
            assert proc.poll() is None, (
                f"--shards {k} exited rc={proc.returncode} before its shards started:\n"
                + out_path.read_text(errors="replace")[-3000:])
            assert time.perf_counter() - t0 < 300, f"--shards {k}: shards not up in 300 s"
            time.sleep(0.2)
        startup_s = time.perf_counter() - t0
        counts, seconds, (contexts, used), dash = asyncio.run(
            bus_window(bus_port, window, names, dashboard))
        t_stop = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=180)
        stop_s = time.perf_counter() - t_stop
    finally:  # after a failed check, or a shard the supervisor left behind
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    log_text = out_path.read_text(errors="replace")
    assert rc == 0, f"--shards {k} exited rc={rc} on SIGTERM:\n{log_text[-3000:]}"
    missing = sorted(set(names) - set(counts))
    assert not missing, f"--shards {k}: no event on the bus from {missing}"
    assert contexts - contexts_before == k, (
        f"--shards {k}: {contexts - contexts_before} new contexts on the card")
    shards = []
    for i in range(k):
        shard_log = (wdir / f"shard.log.shard{i}").read_text(errors="replace")
        share = len(names[i::k])
        assert f"shard {i}/{k}: serving {share} streams" in shard_log, (
            f"shard {i}/{k} did not log its {share} streams")
        stats = last_batcher_stats(shard_log) or {}
        shard = dict(index=i, streams=share, batches=stats.get("batches"),
                     avg_batch=stats.get("avg_batch_size"),
                     avg_infer_ms=stats.get("avg_infer_ms"), shed=stats.get("shed"),
                     warmup_steps=4 * shard_log.count("warmup: bucket"))
        if traced:
            launches = trace_kernels(wdir / "trace" / f"shard{i}")
            for name in SHARD_KERNELS:
                assert launches[name] > 0, f"shard {i}: {name} not in its trace"
            for name in SHARD_ABSENT:
                assert launches[name] == 0, f"shard {i}: {name} in its trace"
            # B2 runs once a step on this path, so its count is the trace's
            # steps; the last [batcher] line is up to one stats interval old
            steps = launches["decode_v8_kernel"]
            assert steps >= shard["warmup_steps"] + (shard["batches"] or 0), (steps, shard)
            shard.update(trace_launches=dict(launches), trace_steps=steps,
                         launches_per_step={n: c / steps for n, c in launches.items() if c})
        shards.append(shard)
    events = sum(counts.values())
    return dict(k=k, dashboard=dash, startup_s=startup_s, window_s=seconds, events=events,
                frames_per_s_at_sink=events / seconds,
                min_events_per_stream=min(counts.values()), streams=len(counts),
                card_contexts_before=contexts_before, card_contexts_during=contexts,
                card_used_mib_before=used_before, card_used_mib_during=used,
                card_mib_per_shard=(used - used_before) / k,
                stop_s=stop_s, rc=rc, shards=shards)


def run_shards(detector: dict, streams, in_process: dict):
    """Phase 15: K = 2 (the dashboard beside it) and K = 4, then a short
    traced K = 2 run; beside them the in-process pipeline of phase 14."""
    runs = {f"k{k}": drive_shards(k, window, detector, streams, dashboard=(k == 2))
            for k, window in SHARD_RUNS}
    dash = runs["k2"]["dashboard"]
    for run in runs.values():
        del run["dashboard"]
    traced = drive_shards(2, TRACED_WINDOW, detector, streams, traced=True)
    return dict(runs, traced_k2={"startup_s": traced["startup_s"],
                                 "shards": traced["shards"]},
                in_process=in_process), dash


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible — this test runs on the card",
              file=sys.stderr)
        return 1
    # without the package beside it this fails here, before any output
    from realtime_analytics_tpu_torch.ops import _cuda

    global CARD
    CARD = card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False  # fp32 comparisons are true fp32
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    info = _cuda.build()
    _cuda.lib()
    log(f"built {info.path.name} in {info.seconds:.1f}s "
        f"(phase wall {time.perf_counter() - t0:.1f}s)")
    for line in info.ptxas:
        log(f"  {line.strip()}")
    log("B3 ptxas " + json.dumps(stem_ptxas(info.ptxas)))

    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        kernels = [check_gather(gen), check_decode(gen), check_stem(gen),
                   check_letterbox(gen), check_nms_keep(gen)]
        torch.cuda.synchronize()
    torch.cuda.empty_cache()

    from realtime_analytics_tpu_torch.ingest.synthetic import SyntheticSource
    from realtime_analytics_tpu_torch.models.resnet import build_resnet
    from realtime_analytics_tpu_torch.models.weights import (
        resnet_synthetic_params,
        synthetic_params,
    )
    from realtime_analytics_tpu_torch.models.yolo import build_yolo

    params = synthetic_params(build_yolo("yolov8", "n", 80), seed=0)
    frames = np.stack([SyntheticSource(width=1920, height=1080, boxes=4, seed=i).read()[1]
                       for i in range(N)])
    frames720 = np.stack([SyntheticSource(width=1280, height=720, boxes=4, seed=i).read()[1]
                          for i in range(N)])
    paths, walls, t_lap = {}, {}, time.perf_counter()

    def lap(name):  # wall seconds of the phase that just ended
        nonlocal t_lap
        now = time.perf_counter()
        walls[name], t_lap = now - t_lap, now

    paths["main"], engine, bf16_res = run_engine(params, frames)
    log("engine " + json.dumps(dict(engine, card=card)))
    lap("main")
    paths["device_resize"], resize = run_device_resize(params, frames720)
    log("device_resize " + json.dumps(dict(resize, card=card)))
    lap("device_resize")
    paths["int8"], int8 = run_int8(params, frames, bf16_res, engine)
    log("int8 " + json.dumps(dict(int8, card=card)))
    lap("int8")
    paths["yolov5"], v5 = run_yolov5(frames)
    log("yolov5 " + json.dumps(dict(v5, card=card)))
    lap("yolov5")
    paths["tiled"], tiled = run_tiled(params, frames[:8])
    log("tiled " + json.dumps(dict(tiled, card=card)))
    lap("tiled")
    resnet_params = resnet_synthetic_params(build_resnet("resnet50", 1000), seed=0)
    resnet_paths, resnet = run_resnet(resnet_params, frames)
    paths.update(resnet_paths)
    log("resnet50 " + json.dumps(dict(resnet, card=card)))
    lap("resnet")
    temporal_paths, temporal = run_temporal(frames)
    paths.update(temporal_paths)
    log("temporal " + json.dumps(dict(temporal, card=card)))
    lap("temporal")
    onnx_paths, onnx = run_onnx(params, frames, resnet_params)
    paths.update(onnx_paths)
    log("onnx " + json.dumps(dict(onnx, card=card)))
    lap("onnx")
    torch.cuda.empty_cache()
    artifact_paths, artifact = run_artifact(params, frames, frames720, resnet_params)
    paths.update(artifact_paths)
    log("artifact " + json.dumps(dict(artifact, card=card)))
    lap("artifact")
    torch.cuda.empty_cache()
    train_paths, train = run_train(params)
    paths.update(train_paths)
    log("train " + json.dumps(dict(train, card=card)))
    lap("train")

    pipeline_detector = dict(
        model_path=saved_tree("yolov8n_seeded.npz", params), confidence_threshold=0.25,
        batch_buckets=None, warmup=True, warmup_source_hw=[1080, 1920])
    paths["pipeline"], pipe = run_pipeline(detector_config(**pipeline_detector), N, 15.0)
    log("pipeline " + json.dumps(dict(pipe, card=card)))
    lap("pipeline")
    paths["resnet_pipeline"], rpipe = run_pipeline(resnet_config(
        model_path=saved_tree("resnet50_seeded.npz", resnet_params), max_batch_size=8,
        batch_buckets=[8], warmup=True, warmup_source_hw=[1080, 1920]), 8, 5.0)
    require_launched("ResNet-50 pipeline", paths["resnet_pipeline"], ("letterbox",))
    log("resnet50_pipeline " + json.dumps(dict(rpipe, card=card)))
    lap("resnet_pipeline")
    # the same detector and streams through the CLI: K shards, one bus
    torch.cuda.empty_cache()
    shards, dash = run_shards(
        dataclasses.asdict(detector_config(**pipeline_detector)), pipeline_streams(N),
        dict(frames_per_s=pipe["sink_messages"] / 15.0, window_s=15.0,
             latency_ms_p99=pipe["latency_ms_p99"], shed=pipe["shed"]))
    log("dashboard " + json.dumps(dict(dash, card=card)))
    log("shards " + json.dumps(dict(shards, card=card)))
    lap("shards")

    log("launches by path " + json.dumps(paths))
    log("phase wall s " + json.dumps(dict(walls, total_since_start=time.perf_counter() - t0)))
    # launches: one step of the path whose shapes the row times (the main
    # path for B1-B3 and B6, the device-resize step for B4); launches_by_path:
    # each path's own count, read just after its own reset
    for row, path in zip(kernels, ("main", "main", "main", "device_resize", "main")):
        row["launches"] = paths[path][row["name"]]
        row["launches_by_path"] = {p: c[row["name"]] for p, c in paths.items()}
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
