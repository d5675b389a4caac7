#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA H100.

Run from the root of a checkout, on a machine with one card:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package. Phases, in order:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. build every kernel of the main path from ``realtime_analytics_tpu_torch/
   csrc`` with nvcc for sm_90a (build seconds, ``-Xptxas -v`` lines);
3. each kernel (B1 row gather, B2 head decode, B3 fused stem) against its
   plain PyTorch version on the card, at the main path's shapes (N=32, 640
   input, bf16; B3 also fp32), timed with CUDA events next to its plain
   version, the one PyTorch call that computes the same function where
   there is one, and its bound (the larger of bytes over 3.35 TB/s and
   operations over the dtype's dense peak, H100 SXM data sheet);
4. the main path: ``TorchYoloEngine`` (YOLOv8n, 640, bf16, bucket 32,
   seeded He-scaled weights) on 32 synthetic 1080p frames through
   ``predict_arrays`` (host pick -> selected step), with every kernel's
   launch counter reset just before and read just after; held against the
   same engine with the kernels off (bf16 model outputs within the repo's
   bf16 fidelity bound; bf16 detections with B1 + B2 off and fp32
   detections with every kernel off, frame by frame); step time, frames/s
   and peak memory;
5. the pipeline: ``AnalyticsPipeline`` with 32 pooled ``synthetic://``
   1080p streams at 25 fps for about 15 s;
6. the ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero without the last line; so does a machine with no
visible CUDA card, or a directory without the package.
"""

from __future__ import annotations

import asyncio
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N = 32  # frames per step: the 32-stream main path's bucket
HW = 640
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
ROOT = Path(__file__).resolve().parent


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
    for m, p, k in ((8400, 4, 512), (512, 6, 300)):  # batched_nms's two calls
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
        lib_ms = cuda_ms(lambda: torch.gather(payload, 1, idx[..., None].expand(-1, -1, p)),
                         iters=200)
        nbytes = N * k * 8 + 2 * N * k * p * 4  # idx + gathered rows + output
        b_ms, b_by = bound(nbytes, 0.0, torch.float32)
        rows.append(dict(shape=[N, m, p, k], max_abs_err=0.0, bit_exact=exact,
                         ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by, bytes=nbytes))
    log("B1 " + json.dumps(rows))
    first = rows[0]
    return dict(name="row_gather", route="cuda",
                source="realtime_analytics_tpu_torch/csrc/gather.cu",
                replaces="realtime_analytics_tpu/ops/pallas_gather.py:46",
                max_abs_err=0.0, ms=first["ms"], plain_ms=first["plain_ms"],
                bound_ms=first["bound_ms"], bound_by=first["bound_by"],
                library_ms=first["library_ms"])


def check_decode(gen):
    from realtime_analytics_tpu_torch.ops.decode import (
        decode_v8_level,
        decode_v8_level_plain,
    )

    levels = []
    for h, stride in ((HW // 8, 8.0), (HW // 16, 16.0), (HW // 32, 32.0)):
        box = (torch.randn(N, h, h, 64, generator=gen, device="cuda") * 3).bfloat16()
        cls = (torch.randn(N, h, h, 80, generator=gen, device="cuda") * 3).bfloat16()
        cls[:, 0] = 0.0                      # all 80 tied: class 0 must win
        cls[:, 1, :, 10] = 40.0              # two-way tie at the max:
        cls[:, 1, :, 20] = 40.0              # class 10 must win
        levels.append((box, cls, stride))
    err_box = err_conf = 0.0
    for box, cls, stride in levels:
        got = decode_v8_level(box, cls, stride=stride)
        want = decode_v8_level_plain(box, cls, stride=stride)
        err_box = max(err_box, (got[0] - want[0]).abs().max().item())
        err_conf = max(err_conf, (got[1] - want[1]).abs().max().item())
        assert torch.equal(got[2], want[2]), "B2 class ids differ"
        assert bool((got[2][:, : box.shape[2]] == 0).all())
        assert bool((got[2][:, box.shape[2]: 2 * box.shape[2]] == 10).all())
    log(f"B2 max |boxes| err {err_box:.3g} px (tol 1e-3), max |conf| err "
        f"{err_conf:.3g} (tol 1e-5), cls exact")
    assert err_box <= 1e-3 and err_conf <= 1e-5

    def run(fn):
        return lambda: [fn(b, c, stride=s) for b, c, s in levels]

    ms = cuda_ms(run(decode_v8_level))
    plain_ms = cuda_ms(run(decode_v8_level_plain))
    anchors = sum(b.shape[1] * b.shape[2] for b, _, _ in levels) * N
    nbytes = anchors * ((64 + 80) * 2 + (4 + 1 + 1) * 4)
    flops = anchors * 480.0  # 4 x 16-bin max/exp/num/den + 80-way max + box
    b_ms, b_by = bound(nbytes, flops, torch.float32)
    row = dict(name="decode_v8", route="cuda",
               source="realtime_analytics_tpu_torch/csrc/decode.cu",
               replaces="realtime_analytics_tpu/ops/pallas_decode.py:61",
               max_abs_err=max(err_box, err_conf), ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log("B2 " + json.dumps(dict(row, anchors=anchors, bytes=nbytes,
                                box_err_px=err_box, conf_err=err_conf)))
    return row


def check_stem(gen):
    import torch.nn.functional as F

    from realtime_analytics_tpu_torch.ops.stem import (
        fused_stem_p1p2,
        fused_stem_p1p2_plain,
        prepare_stem,
    )

    c0, c1 = 16, 32  # YOLOv8n
    w0 = torch.randn(c0, 3, 3, 3, generator=gen, device="cuda") * (2 / 27) ** 0.5 / 255
    b0 = torch.randn(c0, generator=gen, device="cuda") * 0.05
    w1 = torch.randn(c1, c0, 3, 3, generator=gen, device="cuda") * (2 / 144) ** 0.5
    b1 = torch.randn(c1, generator=gen, device="cuda") * 0.05
    x8 = torch.randint(0, 256, (N, HW, HW, 3), generator=gen, device="cuda",
                       dtype=torch.uint8)  # raw pixels (stem-folded weights)
    out = {}
    for dtype, tol_name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        sw = prepare_stem(w0, b0, w1, b1, dtype)
        x = x8.to(dtype)
        got, want = fused_stem_p1p2(x, sw), fused_stem_p1p2_plain(x, sw)
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        # bf16: P1 is rounded to bf16 in both, so an fp32 accumulation-order
        # difference can flip one P1 rounding: allow 1% of the output range;
        # fp32: accumulation order only
        tol = 1e-2 * scale if dtype == torch.bfloat16 else 1e-4
        log(f"B3 {tol_name}: max abs err {err:.3g} (tol {tol:.3g}, max |out| {scale:.3g})")
        assert err <= tol, f"B3 {tol_name} disagrees"
        ms = cuda_ms(lambda: fused_stem_p1p2(x, sw), iters=20)
        plain_ms = cuda_ms(lambda: fused_stem_p1p2_plain(x, sw), iters=20)
        xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view
        w0c, w1c = w0.to(dtype), w1.to(dtype)
        b0c, b1c = b0.to(dtype), b1.to(dtype)
        chain_ms = cuda_ms(lambda: F.silu(F.conv2d(
            F.silu(F.conv2d(xc, w0c, b0c, stride=2, padding=1)), w1c, b1c,
            stride=2, padding=1)), iters=20)
        esz = 2 if dtype == torch.bfloat16 else 4
        nbytes = N * HW * HW * 3 * esz + N * (HW // 4) ** 2 * c1 * esz
        flops = 2.0 * (N * (HW // 2) ** 2 * c0 * 27 + N * (HW // 4) ** 2 * c1 * 9 * c0)
        b_ms, b_by = bound(nbytes, flops, dtype)
        out[tol_name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             cudnn_chain_ms=chain_ms, bound_ms=b_ms, bound_by=b_by,
                             bytes=nbytes, flops=flops)
    log("B3 " + json.dumps(out))
    bf = out["bf16"]
    return dict(name="fused_stem", route="cuda",
                source="realtime_analytics_tpu_torch/csrc/stem.cu",
                replaces="realtime_analytics_tpu/ops/pallas_stem.py:136",
                max_abs_err=bf["max_abs_err"], ms=bf["ms"], plain_ms=bf["plain_ms"],
                bound_ms=bf["bound_ms"], bound_by=bf["bound_by"], library_ms=None)


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


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


def model_outputs(eng, frames):
    """The engine's model outputs (before NMS) on its selected-step input:
    the host pick, then pad + cast on the card, as ``_step_selected``."""
    from realtime_analytics_tpu_torch.ops.preprocess import letterbox_spec

    spec = letterbox_spec(frames.shape[1:3], eng.input_hw)
    sel, selected = eng.host_prepare(frames, frames.shape[1:3])
    assert selected
    with torch.inference_mode():
        x = eng._pad_cast(torch.from_numpy(sel).cuda(), spec)
        out = eng._forward_selected(x)
    return {k: v.float() for k, v in out.items()}


def hold(name, a, b, score_tol, box_tol):
    """Detections of two engines agree on every frame: num_valid and
    classes equal, scores and boxes within the tolerances."""
    same, score_d, box_d = compare(a, b)
    log(f"{name}: {same}/{N} frames with equal num_valid and classes, max "
        f"|score| delta {score_d:.3g} (tol {score_tol}), max |box| delta "
        f"{box_d:.3g} px (tol {box_tol})")
    assert same == N and score_d <= score_tol and box_d <= box_tol, f"{name} disagree"
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
    for name, count in launches.items():
        assert count > 0, f"kernel {name} was not launched on the main path"
    b = res.boxes_xyxy
    assert b.shape == (N, 300, 4) and np.isfinite(b).all() and np.isfinite(res.scores).all()
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
    times = []
    for _ in range(25):
        t0 = time.perf_counter()
        eng.predict_arrays(frames)  # ends in device->host copies: synchronised
        times.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(times)
    mem = torch.cuda.max_memory_allocated() / 2**20
    summary = dict(step_ms_median=step_ms, step_ms_min=min(times),
                   frames_per_s=N / step_ms * 1e3, max_memory_allocated_mib=mem,
                   bf16_conf_max_delta=conf_d, bf16_box_median_delta_px=box_med,
                   bf16_class_agreement=cls_agree, bf16_all_off_frames_equal=all_off,
                   fp32_score_max_delta=score32, fp32_box_max_delta_px=box32)
    return launches, summary


# ---------------------------------------------------------------------------
# phase 5: the pipeline
# ---------------------------------------------------------------------------


def run_pipeline(params, seconds: float = 15.0):
    from realtime_analytics_tpu_torch.config import (
        KafkaSinkConfig,
        PipelineConfig,
        PrometheusConfig,
        SnapshotConfig,
        StreamConfig,
        TrackerConfig,
    )
    from realtime_analytics_tpu_torch.pipeline import AnalyticsPipeline

    wdir = ROOT / "build" / "chip_smoke"
    wdir.mkdir(parents=True, exist_ok=True)
    weights = wdir / "yolov8n_seeded.npz"
    np.savez(weights, __pytree__=np.array(params, dtype=object))
    cfg = PipelineConfig(
        streams=[
            StreamConfig(
                name=f"cam-{i:02d}",
                url=f"synthetic://?width=1920&height=1080&boxes=4&seed={i}&pool=10",
                target_fps=25, warmup_seconds=0.0, batch_size=2, adaptive_fps=False,
            )
            for i in range(N)
        ],
        detector=detector_config(model_path=str(weights), confidence_threshold=0.25,
                                 batch_buckets=None, warmup=True,
                                 warmup_source_hw=[1080, 1920]),
        tracker=TrackerConfig(),
        kafka=KafkaSinkConfig(enabled=True, transport="memory"),
        prometheus=PrometheusConfig(enabled=False),
        snapshots=SnapshotConfig(enabled=False),
        batch_window_ms=4,
        stats_interval_seconds=3600,
    )
    pipeline = AnalyticsPipeline(cfg)
    t0 = time.perf_counter()
    asyncio.run(pipeline.run_for(seconds))
    wall = time.perf_counter() - t0
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
        latency_samples=len(lat),
    )
    assert min(per_stream) > 0, f"a stream processed no frames: {per_stream}"
    assert stats.frames > 0 and pipeline.kafka.messages_sent > 0
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible — this test runs on the card",
              file=sys.stderr)
        return 1
    # without the package beside it this fails here, before any output
    from realtime_analytics_tpu_torch.ops import _cuda

    card = card_line()
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

    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        kernels = [check_gather(gen), check_decode(gen), check_stem(gen)]
        torch.cuda.synchronize()

    from realtime_analytics_tpu_torch.ingest.synthetic import SyntheticSource
    from realtime_analytics_tpu_torch.models.weights import synthetic_params
    from realtime_analytics_tpu_torch.models.yolo import build_yolo

    params = synthetic_params(build_yolo("yolov8", "n", 80), seed=0)
    frames = np.stack([SyntheticSource(width=1920, height=1080, boxes=4, seed=i).read()[1]
                       for i in range(N)])
    launches, engine = run_engine(params, frames)
    log("engine " + json.dumps(dict(engine, card=card)))
    pipe = run_pipeline(params)
    log("pipeline " + json.dumps(dict(pipe, card=card)))

    for row in kernels:
        row["launches"] = launches[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
