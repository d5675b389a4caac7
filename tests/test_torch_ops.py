"""The port's tensor ops against the JAX package, on the CPU.

Geometry and preprocess follow the cases of tests/test_ops.py; the B1 row
gather follows tests/test_pallas_gather.py (the JAX kernel in interpret
mode); batched NMS must be EXACTLY equal to both JAX gather impls on fp32
inputs, tied scores and class-aware NMS included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_analytics_tpu.ops import nms as jnms
from realtime_analytics_tpu.ops import preprocess as jpre
from realtime_analytics_tpu.ops.boxes import iou_matrix as j_iou
from realtime_analytics_tpu.ops.boxes import unletterbox_boxes as j_unletterbox
from realtime_analytics_tpu.ops.pallas_gather import pallas_row_gather
from realtime_analytics_tpu_torch.ops import boxes as tboxes
from realtime_analytics_tpu_torch.ops import preprocess as tpre
from realtime_analytics_tpu_torch.ops.gather import row_gather, row_gather_plain
from realtime_analytics_tpu_torch.ops.nms import batched_nms


def random_boxes(rng, n, size=640):
    xy = rng.uniform(0, size * 0.8, (n, 2))
    wh = rng.uniform(8, size * 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


# -- geometry -----------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [
    ((1080, 1920), (640, 640)), ((480, 640), (640, 640)), ((640, 640), (640, 640)),
    ((97, 211), (640, 640)), ((100, 300), (64, 64)), ((360, 640), (320, 320)),
])
def test_letterbox_spec_and_axis_reduction_match_jax(src, dst):
    t, j = tpre.letterbox_spec(src, dst), jpre.letterbox_spec(src, dst)
    assert t.__dict__ == j.__dict__
    for s, d in ((src[0], t.new_h), (src[1], t.new_w), (9, 3), (8, 4), (7, 3)):
        assert tpre.integer_axis_reduction(s, d) == jpre.integer_axis_reduction(s, d)


def test_iou_and_unletterbox_match_jax(rng):
    a, b = random_boxes(rng, 13), random_boxes(rng, 7)
    np.testing.assert_array_equal(
        tboxes.iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(j_iou(jnp.asarray(a), jnp.asarray(b))),
    )
    spec = tpre.letterbox_spec((1080, 1920), (640, 640))
    bx = random_boxes(rng, 20)[None]
    got = tboxes.unletterbox_boxes(torch.from_numpy(bx), spec.scale, spec.pad_left,
                                   spec.pad_top, 1080, 1920).numpy()
    want = np.asarray(j_unletterbox(jnp.asarray(bx), spec.scale, spec.pad_left,
                                    spec.pad_top, 1080, 1920))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


# -- preprocess ---------------------------------------------------------------


@pytest.mark.parametrize("src_hw,dst", [
    ((1080, 1920), (640, 640)),  # select (3x pick)
    ((360, 640), (320, 320)),    # mean2 (2x)
    ((480, 640), (640, 640)),    # fractional (upscale)
    ((97, 211), (64, 64)),       # fractional (downscale)
])
def test_preprocess_batch_matches_jax(rng, src_hw, dst):
    frames = rng.integers(0, 256, (2, *src_hw, 3), dtype=np.uint8)
    tspec, jspec = tpre.letterbox_spec(src_hw, dst), jpre.letterbox_spec(src_hw, dst)
    got = tpre.preprocess_batch(torch.from_numpy(frames), spec=tspec,
                                out_dtype=torch.float32, layout="NHWC").numpy()
    want = np.asarray(jpre.preprocess_batch(jnp.asarray(frames), spec=jspec,
                                            out_dtype=jnp.float32, layout="NHWC"))
    assert got.shape == want.shape
    red_h = tpre.integer_axis_reduction(src_hw[0], tspec.new_h)
    red_w = tpre.integer_axis_reduction(src_hw[1], tspec.new_w)
    if red_h is not None and red_w is not None:
        np.testing.assert_array_equal(got, want)  # select / mean2: exact
    else:
        # torch's bilinear edge clamping vs jax.image.resize's edge
        # renormalisation: the same taps; only float order may move an
        # exact .5 interpolant across the cv2 half-up rounding
        diff = np.abs(got - want) * 255.0
        assert diff.max() <= 1.01
        assert np.mean(diff > 0.01) < 0.01


@pytest.mark.parametrize("src_hw", [(1080, 1920), (480, 640), (640, 640), (97, 211)])
def test_letterbox_numpy_oracle_matches_jax_and_preprocess(rng, src_hw):
    """The port's cv2 oracle is the JAX package's, and the port's
    preprocess_batch stays at tests/test_ops.py's distance from it (cv2's
    fixed-point taps: at most 3 levels, more than 1 level on < 2%)."""
    frame = rng.integers(0, 256, (*src_hw, 3), dtype=np.uint8)
    got, meta = tpre.letterbox_numpy(frame, (640, 640))
    want, jmeta = jpre.letterbox_numpy(frame, (640, 640))
    np.testing.assert_array_equal(got, want)
    assert meta == jmeta and meta["orig_shape"] == src_hw
    out = tpre.preprocess_batch(torch.from_numpy(frame[None]),
                                spec=tpre.letterbox_spec(src_hw, (640, 640)),
                                out_dtype=torch.float32).numpy()
    diff = np.abs(out - got)
    assert diff.max() <= 3.01 / 255.0
    assert np.mean(diff > 1.01 / 255.0) < 0.02


def test_preprocess_nchw_layout_and_pad(rng):
    frames = rng.integers(0, 256, (1, 480, 640, 3), dtype=np.uint8)
    spec = tpre.letterbox_spec((480, 640), (640, 640))
    out = tpre.preprocess_batch(torch.from_numpy(frames), spec=spec,
                                out_dtype=torch.float32).numpy()
    assert out.shape == (1, 3, 640, 640)
    np.testing.assert_allclose(out[0, :, : spec.pad_top, :], 114.0 / 255.0, atol=1e-6)


# -- B1 row gather ------------------------------------------------------------


@pytest.mark.parametrize("n,m,p,k", [
    (3, 100, 6, 7), (1, 128, 3, 128), (2, 1024, 5, 64), (2, 8400, 4, 512),
    (1, 300, 1, 4),
])
def test_row_gather_plain_bit_exact_vs_pallas(n, m, p, k):
    rng = np.random.default_rng(n * 1000 + m + p + k)
    payload = (rng.normal(size=(n, m, p)) * rng.choice([1.0, 640.0, 1e-3], (n, m, p))
               ).astype(np.float32)
    idx = rng.integers(0, m, (n, k))
    want = np.asarray(pallas_row_gather(jnp.asarray(payload),
                                        jnp.asarray(idx.astype(np.int32)),
                                        interpret=True))
    got = row_gather(torch.from_numpy(payload), torch.from_numpy(idx)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_row_gather_special_floats_and_boundaries():
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 3.14159],
                        np.float32)
    payload = np.tile(specials, (1, 16, 1)).reshape(1, 16, 8).astype(np.float32)
    idx = np.array([[3, 0, 15, 15]])
    want = np.asarray(pallas_row_gather(jnp.asarray(payload),
                                        jnp.asarray(idx.astype(np.int32)),
                                        interpret=True))
    got = row_gather_plain(torch.from_numpy(payload), torch.from_numpy(idx)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# -- batched NMS --------------------------------------------------------------


def _nms_inputs(seed, n=3, m=900, ties=False):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 600, (n, m, 2))
    wh = rng.uniform(5, 120, (n, m, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    scores = rng.uniform(0, 1, (n, m)).astype(np.float32)
    if ties:  # coarse scores: many exact ties decided by index order
        scores = np.round(scores * 8) / 8
    scores[scores < 0.4] = 0.0  # conf-masked contract
    classes = rng.integers(0, 8, (n, m)).astype(np.int32)
    return boxes, scores, classes


@pytest.mark.parametrize("seed,ties,class_agnostic,pre_topk,max_det", [
    (7, False, True, 256, 50),
    (8, True, True, 256, 300),   # tied scores; max_det > K pads
    (9, False, False, 512, 100),  # class-aware (global min/max offset)
    (10, True, False, 128, 64),
])
def test_batched_nms_exactly_equals_jax(seed, ties, class_agnostic, pre_topk, max_det):
    boxes, scores, classes = _nms_inputs(seed, ties=ties)
    kw = dict(iou_threshold=0.45, max_det=max_det, pre_topk=pre_topk,
              class_agnostic=class_agnostic)
    got = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                      torch.from_numpy(classes), **kw)
    got_torch = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                            torch.from_numpy(classes), gather_impl="torch", **kw)
    for impl in ("xla", "pallas_interpret"):
        want = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                jnp.asarray(classes), gather_impl=impl, **kw)
        for g, gt, w, name in zip(got, got_torch, want,
                                  ("boxes", "scores", "classes", "nvalid")):
            w = np.asarray(w)
            assert np.array_equal(g.numpy(), w), (impl, name)
            assert np.array_equal(gt.numpy(), w), (impl, name, "torch gather")
            assert g.numpy().dtype == w.dtype, name


def test_batched_nms_class_aware_negative_coordinates():
    boxes = np.array([[[-11800, 10, -11300, 400], [-19993, 10, -19493, 400]]],
                     dtype=np.float32)
    scores = np.array([[0.9, 0.8]], dtype=np.float32)
    classes = np.array([[0, 1]], dtype=np.int32)
    *_, nv = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(classes), iou_threshold=0.5, max_det=8,
                         pre_topk=2, class_agnostic=False)
    assert int(nv[0]) == 2


def test_nms_gather_indices_in_range(monkeypatch):
    """B1's index contract (no check on the card): every index batched_nms
    hands the gather is in [0, M)."""
    import realtime_analytics_tpu_torch.ops.nms as tnms

    boxes, scores, classes = _nms_inputs(11)
    seen = []

    def spy(payload, idx):
        seen.append((payload.shape[1], int(idx.min()), int(idx.max())))
        return row_gather(payload, idx)

    monkeypatch.setattr(tnms, "row_gather", spy)
    batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                torch.from_numpy(classes), iou_threshold=0.45, max_det=300,
                pre_topk=512)
    assert len(seen) == 2
    for m, lo, hi in seen:
        assert 0 <= lo and hi < m
