"""Kernel B6 (``csrc/nms.cu``, ``ops/nms.nms_keep_boxes`` and ``nms_keep``):
greedy NMS's keep pass.

The kernel runs only on the card; here numpy replays of its two passes are
held against PyTorch, bit for bit (the keep mask is boolean and the greedy
pass is the fixpoint's unique solution):

- the mask pass from the boxes, in the kernel's float32 operation order
  (NaN-keeping max and min, no FMA, an IEEE division, the threshold in
  float32), against ``iou_matrix > thr``: seeded boxes, IoUs exactly at
  f32(0.3), 0.45 and 0.5, zero-area and inverted boxes, tiny boxes whose
  union is under 1e-6, a NaN box, negative and class-shifted coordinates;
- the mask pass from an overlap matrix (bool bytes packed four at a time,
  a warp's 32 ballots transposing the tile), and the chain (32-rank steps:
  the diagonal words resolved in bit steps, the kept rows ORed forward),
  against a greedy pass in rank order at K in {1, 31, 32, 33, 512, 1025},
  seeded and hypothesis-drawn, and against the plain sweeps;
- ``nms_keep_boxes_plain`` against the overlap-plus-sweeps code that
  ``batched_nms`` ran before it.

``batched_nms`` through the registered ops equals ``batched_nms`` through
the wrappers, and a trace keeps B6 as one ``rva::nms_keep_boxes`` node
with no [N, K, K] value and no ``aten.equal`` (the sweeps' host test).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from realtime_analytics_tpu_torch.ops import _cuda
from realtime_analytics_tpu_torch.ops.boxes import iou_matrix
from realtime_analytics_tpu_torch.ops.nms import (
    SCRATCH_BYTES,
    SMEM_ROWS,
    batched_nms,
    mask_words,
    nms_keep,
    nms_keep_boxes,
    nms_keep_boxes_plain,
    nms_keep_plain,
    scratch_chunk,
)


def _overlaps(rng, n, k, p, valid_p):
    """Random strictly lower-triangular overlaps between valid candidates."""
    s = rng.random((n, k, k)) < p
    valid = rng.random((n, k)) < valid_p
    ov = s & np.tril(np.ones((k, k), bool), -1) & valid[:, :, None] & valid[:, None, :]
    return ov, valid


def _greedy(ov, valid):
    """keep[i] = valid[i] and no kept j < i overlaps i, rank by rank."""
    keep = np.zeros_like(valid)
    for b in range(valid.shape[0]):
        for i in range(valid.shape[1]):
            keep[b, i] = valid[b, i] and not (ov[b, i, :i] & keep[b, :i]).any()
    return keep


def _bits4(v: int) -> int:
    """csrc/nms.cu bits4: four bool bytes of a little-endian word -> 4 bits."""
    x = v & 0x01010101
    x |= x >> 7
    x |= x >> 14
    return x & 0xF


def _pack_word(row: np.ndarray, q: int, k: int, vec: bool) -> int:
    """csrc/nms.cu pack_word: columns [32q, 32q + 32) of a row as a word."""
    c0 = q * 32
    if vec:  # k % 16 == 0: 16-byte units, each four little-endian words
        def unit(c):
            words = row[c:c + 16].astype(np.uint8).view("<u4")
            return sum(_bits4(int(w)) << (4 * j) for j, w in enumerate(words))
        w = unit(c0)
        if c0 + 16 < k:
            w |= unit(c0 + 16) << 16
        return w
    return sum(int(row[c0 + b] != 0) << b for b in range(32) if c0 + b < k)


def _tri_base(b: int, w: int) -> int:
    """csrc/nms.cu tri_base: tiles (and words a row) before row block b."""
    return b * w - b * (b - 1) // 2


def _word_index(b: int, t: int, q: int, w: int) -> int:
    """Where the mask pass writes row 32b + t's word q (q >= b) of an image."""
    return 32 * _tri_base(b, w) + t * (w - b) + (q - b)


def _pack_pass(ov: np.ndarray, k: int) -> np.ndarray:
    """csrc/nms.cu's mask pass on an overlap matrix (``nms_keep``), warp for
    warp: tile (b, q) with q >= b; lane s packs row j = 32q + s at the
    columns of block b (``pack_word``); 32 ballots give lane t the word over
    s of the worse j that row i = 32b + t suppresses; on the diagonal tile
    the bits below t are row i's own (the better ranks that suppress it);
    rows past k are 0."""
    w = -(-k // 32)
    vec = k % 16 == 0
    words = np.zeros(mask_words(k), np.uint32)
    rows = ov.view(np.uint8)
    for b in range(w):
        for q in range(b, w):
            mine = [_pack_word(rows[32 * q + s], b, k, vec) if 32 * q + s < k else 0
                    for s in range(32)]
            for t in range(32):
                word = sum(((mine[s] >> t) & 1) << s for s in range(32))
                if 32 * b + t >= k:
                    word = 0
                if q == b:  # both sides: the ballots above t, row i's own bits below
                    above = 0 if t == 31 else (0xFFFFFFFF << (t + 1)) & 0xFFFFFFFF
                    word = (word & above) | (mine[t] & ((1 << t) - 1))
                words[_word_index(b, t, q, w)] = word
    return words


def _words_of(sup: np.ndarray, k: int) -> np.ndarray:
    """The mask words of ``sup`` [K, K] bool (sup[i, j]: i suppresses the
    worse j > i) in the kernel's layout: row block b's 32 rows, each its
    words q = b .. W-1, row after row; a diagonal word holds both sides of
    its row (sup | sup.T)."""
    w = -(-k // 32)
    pad = np.zeros((32 * w, 32 * w), bool)
    pad[:k, :k] = sup
    blocks = np.arange(32 * w) // 32
    pad |= pad.T & (blocks[:, None] == blocks[None, :])
    packed = np.packbits(pad.reshape(32 * w, w, 32), axis=-1, bitorder="little")
    full = packed.view("<u4")[..., 0]  # [32W, W]: row i's word q
    words = np.zeros(mask_words(k), np.uint32)
    for b in range(w):
        base = 32 * _tri_base(b, w)
        words[base:base + 32 * (w - b)] = full[32 * b:32 * b + 32, b:].reshape(-1)
    return words


def _skip_tiles(words: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The mask pass leaves a tile without a valid row or a valid column
    unwritten: fill those words with garbage, which the chain must never
    let through."""
    k = valid.shape[0]
    w = -(-k // 32)
    live = np.zeros(32 * w, bool)
    live[:k] = valid
    live = live.reshape(w, 32).any(axis=1)
    junk = np.random.default_rng(k + int(valid.sum()))
    out = words.copy()
    for b in range(w):
        for q in range(b, w):
            if not (live[b] and live[q]):
                for t in range(32):
                    out[_word_index(b, t, q, w)] = junk.integers(0, 2**32, dtype=np.uint32)
    return out


def _resolve(r: int, sym: list) -> int:
    """csrc/nms.cu resolve: rounds of one vote from kept = live (lane t
    kept while no kept better rank of the block overlaps it) until nothing
    changes, at most four; else the 32 ranks in order."""
    full = 0xFFFFFFFF
    live = ~r & full
    kept = live
    for _ in range(4):
        nxt = sum(1 << t for t in range(32)
                  if (live >> t) & 1 and not (sym[t] & ((1 << t) - 1) & kept))
        if nxt == kept:
            return kept
        kept = nxt
    for t in range(32):
        if not (r >> t) & 1:
            r |= sym[t]
    return ~r & full


def _chain_pass(words: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """csrc/nms.cu's chain on one image's words, step by step (the staged
    and the scratch instantiations run the same steps): removed[q] starts as
    the ranks not valid (and past k); step b skips a block whose ranks are
    all gone, else resolves its 32 ranks from removed[b] and the diagonal
    words, and ORs each kept rank's words q > b into removed[q]."""
    k = valid.shape[0]
    w = -(-k // 32)
    full = 0xFFFFFFFF
    removed = []
    for q in range(w):
        live = sum(1 << s for s in range(32) if 32 * q + s < k and valid[32 * q + s])
        removed.append(~live & full)
    kept = [0] * w
    for b in range(w):
        if removed[b] == full:
            continue
        sym = [int(words[_word_index(b, t, b, w)]) for t in range(32)]
        kb = kept[b] = _resolve(removed[b], sym)
        for q in range(b + 1, w):
            acc, m = 0, kb
            while m:
                t = (m & -m).bit_length() - 1
                acc |= int(words[_word_index(b, t, q, w)])
                m &= m - 1
            removed[q] |= acc
    return np.array([(kept[i >> 5] >> (i & 31)) & 1 for i in range(k)], bool)


def _replay(ov: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """``nms_keep`` on the card, thread for thread: the pack pass of each
    image's overlap matrix into the mask words (tiles without a valid row
    or column left as garbage), then the chain."""
    n, k = valid.shape
    return np.stack([_chain_pass(_skip_tiles(_pack_pass(ov[i], k), valid[i]), valid[i])
                     for i in range(n)])


def _plain(ov, valid):
    return nms_keep_plain(torch.from_numpy(ov), torch.from_numpy(valid)).numpy()


def _chain(n, k):
    """Every rank overlaps the one before it: the worst case for sweeps
    (one more sweep per rank); greedy keeps every other rank."""
    ov = np.zeros((n, k, k), bool)
    ov[:, np.arange(1, k), np.arange(k - 1)] = True
    return ov, np.ones((n, k), bool)


CASES = {
    "main_512": (2, 512, 0.02, 0.9),
    "k1024": (1, 1024, 0.01, 0.9),
    "k300_unaligned": (2, 300, 0.03, 0.9),
    "all_valid": (2, 512, 0.02, 1.0),
    "none_valid": (2, 512, 0.02, 0.0),
    "small_dense": (3, 17, 0.5, 0.8),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_greedy_equals_fixpoint_seeded(name):
    n, k, p, vp = CASES[name]
    ov, valid = _overlaps(np.random.default_rng(len(name)), n, k, p, vp)
    np.testing.assert_array_equal(_plain(ov, valid), _greedy(ov, valid))


def test_greedy_equals_fixpoint_on_a_chain():
    ov, valid = _chain(2, 64)
    want = _greedy(ov, valid)
    np.testing.assert_array_equal(_plain(ov, valid), want)
    np.testing.assert_array_equal(want[0], np.arange(64) % 2 == 0)


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(st.integers(1, 70), st.floats(0.0, 1.0), st.floats(0.0, 1.0), st.integers(0, 2**31))
def test_greedy_equals_fixpoint_drawn(k, p, vp, seed):
    ov, valid = _overlaps(np.random.default_rng(seed), 2, k, p, vp)
    np.testing.assert_array_equal(_plain(ov, valid), _greedy(ov, valid))


def test_bits4_packs_every_bool_word():
    for m in range(16):
        word = sum(((m >> b) & 1) << (8 * b) for b in range(4))
        assert _bits4(word) == m


@pytest.mark.parametrize("name", ["main_512", "k300_unaligned", "all_valid",
                                  "none_valid", "small_dense"])
def test_kernel_replay_equals_plain(name):
    n, k, p, vp = CASES[name]
    ov, valid = _overlaps(np.random.default_rng(100 + len(name)), 1, k, p, vp)
    np.testing.assert_array_equal(_replay(ov, valid), _plain(ov, valid))


def test_kernel_replay_on_a_chain_and_past_shared_memory():
    ov, valid = _chain(1, 96)
    np.testing.assert_array_equal(_replay(ov, valid), _plain(ov, valid))
    # k > 1024: the rows in the scratch buffer, the keep words in shared
    # memory, lanes 0 and 1 testing two words each (34 words)
    k = SMEM_ROWS + 48
    ov, valid = _overlaps(np.random.default_rng(7), 1, k, 0.002, 0.5)
    np.testing.assert_array_equal(_replay(ov, valid), _plain(ov, valid))
    assert -(-k // 32) > 32


def test_op_equals_wrapper_and_counts_nothing_on_the_cpu():
    ov, valid = _overlaps(np.random.default_rng(3), 4, 256, 0.03, 0.9)
    ov_t, valid_t = torch.from_numpy(ov), torch.from_numpy(valid)
    before = _cuda.LAUNCHES.snapshot()["nms_keep"]
    got = torch.ops.rva.nms_keep(ov_t, valid_t)
    assert got.dtype == torch.bool and got.data_ptr() != valid_t.data_ptr()
    assert torch.equal(got, nms_keep(ov_t, valid_t))
    with _cuda.through_ops():
        assert torch.equal(nms_keep(ov_t, valid_t), got)
    assert _cuda.LAUNCHES.snapshot()["nms_keep"] == before  # CPU: plain version


def _nms_inputs(seed, n=3, m=400):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 300, (n, m, 2)).astype(np.float32)
    wh = rng.uniform(5, 60, (n, m, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1))
    scores = torch.from_numpy(rng.uniform(0, 1, (n, m)).astype(np.float32))
    scores = torch.where(scores > 0.3, scores, 0.0)
    cls = torch.from_numpy(rng.integers(0, 5, (n, m)).astype(np.int32))
    return boxes, scores, cls


@pytest.mark.parametrize("agnostic", [True, False])
def test_batched_nms_through_the_ops_equals_the_wrapper(agnostic):
    boxes, scores, cls = _nms_inputs(11)
    kw = dict(iou_threshold=0.45, max_det=100, pre_topk=256, class_agnostic=agnostic)
    want = batched_nms(boxes, scores, cls, **kw)
    with _cuda.through_ops():
        got = batched_nms(boxes, scores, cls, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_a_trace_keeps_the_keep_pass_as_one_node():
    boxes, scores, cls = _nms_inputs(12)
    k = 256

    class Step(torch.nn.Module):
        def forward(self, b, s, c):
            with _cuda.through_ops():
                return batched_nms(b, s, c, iou_threshold=0.45, max_det=100, pre_topk=k)

    ep = torch.export.export(Step(), (boxes, scores, cls), strict=False)
    calls = [node for node in ep.graph.nodes if node.op == "call_function"]
    targets = [str(node.target) for node in calls]
    assert targets.count("rva.nms_keep_boxes.default") == 1
    assert targets.count("rva.nms_keep.default") == 0
    assert targets.count("rva.row_gather.default") == 2
    assert not any("equal" in t for t in targets)
    # no [N, K, K] value is left in the program: B6 takes the boxes
    shapes = [tuple(v.shape) for node in ep.graph.nodes
              for v in [node.meta.get("val")] if isinstance(v, torch.Tensor)]
    assert (3, k, 4) in shapes
    assert not any(len(sh) >= 3 and sh[-2:] == (k, k) for sh in shapes)
    for a, b in zip(ep.module()(boxes, scores, cls), Step()(boxes, scores, cls)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the mask pass from the boxes


def _nan_max(a, b):
    """csrc/nms.cu nan_max: torch.maximum's NaN."""
    return np.where((a > b) | np.isnan(a), a, b)


def _nan_min(a, b):
    return np.where((a < b) | np.isnan(a), a, b)


def _cut(thr: float):
    """csrc/nms.cu cut_of: (mid, neg, tie) of a float32 threshold."""
    t = np.float32(thr)
    if np.isnan(t) or t == np.inf:
        return np.inf, False, False
    if t < 0:
        return 0.0, True, False
    t = np.abs(t)
    fmax = np.finfo(np.float32).max
    ulp = 2.0 ** 104 if t == fmax else float(np.nextafter(t, np.float32(np.inf))) - float(t)
    return float(t) + ulp / 2, False, bool(t.view(np.uint32) & 1)


def _cut_over(inter: np.ndarray, uni: np.ndarray, thr: float) -> np.ndarray:
    """csrc/nms.cu tame_iou_over's test of RN(inter / uni) > thr: one
    multiply in float64 (exact: 25 x 24 bits), no division."""
    mid, neg, tie = _cut(thr)
    x, p = inter.astype(np.float64), mid * uni.astype(np.float64)
    return neg | (x > p) | (tie & (x == p))


def _mask_replay(boxes: np.ndarray, thr: float) -> np.ndarray:
    """csrc/nms.cu's mask pass for every pair (i, j) of boxes [K, 4] f32,
    the row box i as ``a``, in float32: a pair of tame boxes (every
    coordinate under 2^60 in magnitude) takes ``tame_iou_over`` (fmaxf and
    fminf, no division where the boxes do not intersect), any other pair
    ``iou_over`` (NaN-keeping max and min), each in the kernel's order;
    the tame pairs decide the division by the cut (``_cut_over``)."""
    f = np.float32
    a, b = boxes[:, None, :], boxes[None, :, :]
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        tame = (np.abs(boxes) < f(2.0 ** 60)).all(axis=1)
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        area_sum = area[:, None] + area[None, :]

        def inter_union(mx, mn):
            w = mx(mn(a[..., 2], b[..., 2]) - mx(a[..., 0], b[..., 0]), f(0))
            h = mx(mn(a[..., 3], b[..., 3]) - mx(a[..., 1], b[..., 1]), f(0))
            inter = w * h
            uni = mx(area_sum - inter, f(1e-6))
            assert uni.dtype == np.float32
            return inter, uni

        inter, uni = inter_union(_nan_max, _nan_min)
        exact = inter / uni > f(thr)
        inter, uni = inter_union(np.fmax, np.fmin)
        fast = _cut_over(inter, uni, thr)
        return np.where(tame[:, None] & tame[None, :], fast, exact)


def _exact_pairs():
    """Pairs whose float32 IoU is exactly f32(0.3), f32(0.45) and 0.5:
    a 1 x 3 box inside a 1 x 10 (3/10), 1 x 9 in 1 x 20 (9/20), 1 x 1 in
    1 x 2 (1/2)."""
    return np.array([[0, 0, 1, 3], [0, 0, 1, 10], [5, 5, 6, 14], [5, 5, 6, 25],
                     [9, 0, 10, 1], [9, 0, 10, 2]], np.float32)


def _edge_boxes(rng, k: int) -> np.ndarray:
    """Seeded boxes with every trap: integer corners on a small grid (many
    IoUs are exact ratios, ties at the thresholds), the exact pairs,
    zero-area and inverted boxes, tiny boxes (union under 1e-6), a NaN box,
    negative coordinates."""
    xy = rng.integers(-8, 8, (k, 2))
    wh = rng.integers(0, 6, (k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:6] = _exact_pairs()
    boxes[6] = [3, 3, 3, 7]          # zero width
    boxes[7] = [4, 4, 1, 9]          # inverted in x: a negative area
    boxes[8] = [-2, -2, -3, -3]      # inverted in both: a positive area
    boxes[9] = [0, 0, 4e-4, 4e-4]    # tiny: union under 1e-6
    boxes[10] = [1e-4, 1e-4, 5e-4, 5e-4]
    boxes[11] = [1, np.nan, 5, 5]    # a NaN coordinate
    return boxes


def _class_shifted(boxes: np.ndarray, classes: np.ndarray) -> np.ndarray:
    """``batched_nms``'s class-aware shift, in torch."""
    b = torch.from_numpy(boxes)[None]
    lo = b.min()
    offset = torch.clamp_min(b.max() - lo, 8192.0) + 1.0
    out = (b - lo) + (torch.from_numpy(classes)[None].to(b.dtype) * offset)[..., None]
    return out[0].numpy()


MASK_CASES = ["seeded", "edges", "edges_class_shifted", "edges_shifted_negative", "huge"]


def _mask_case(name: str) -> np.ndarray:
    rng = np.random.default_rng(len(name))
    if name == "seeded":
        xy = rng.uniform(-50, 300, (70, 2)).astype(np.float32)
        return np.concatenate([xy, xy + rng.uniform(1, 60, (70, 2)).astype(np.float32)], -1)
    boxes = _edge_boxes(rng, 70)
    if name == "edges_class_shifted":
        boxes = _class_shifted(np.nan_to_num(boxes), rng.integers(0, 3, 70).astype(np.int32))
        boxes[11, 1] = np.nan
    elif name == "edges_shifted_negative":
        boxes = boxes - np.float32(1000.5)
    elif name == "huge":  # past the tame range: overflows, inf, a width of inf times 0
        inf = np.inf
        boxes[12:20] = [[-3e38, 0, 3e38, 0], [-3e38, 0, 3e38, 1], [0, 0, inf, 5],
                        [-inf, -inf, inf, inf], [2.0 ** 60, 0, 2.0 ** 60 + 2e17, 10],
                        [1e18, 1e18, 1.1e18, 1.1e18], [-2e38, -2e38, 2e38, 2e38],
                        [inf, 0, inf, 4]]
        boxes[20:24] = boxes[12:16] * np.float32(0.5)
    return boxes


def test_cut_decides_the_division_exactly():
    """RN(inter / uni) > thr in float32 against the cut's one multiply in
    float64, on quotients around every threshold (an ulp either side),
    random ones, zero dividends, and thresholds at 0, -0, negative, the
    largest float, inf, NaN and the smallest subnormal (whose midpoint is
    reachable: a tie that rounds up)."""
    f = np.float32
    rng = np.random.default_rng(17)
    tiny = np.float32(2.0 ** -149)
    thresholds = [0.3, 0.45, 0.5, 0.7, 0.0, -0.0, -0.25, float(np.finfo(f).max), np.inf,
                  np.nan, float(tiny), 1e-6]
    uni = rng.uniform(1e-6, 5e4, 4000).astype(f)
    uni[:8] = [1e-6, 1, 2, 3, 0.5, 1e4, 2.5e-6, 7]
    for thr in thresholds:
        t = f(thr)
        with np.errstate(over="ignore", invalid="ignore"):
            base = np.nan_to_num(t * uni, nan=0.0, posinf=f(3e38))
            steps = rng.integers(-1, 2, uni.size).astype(f)
            inter = np.nextafter(base, base + steps * np.abs(base) + steps).astype(f)
            inter = np.abs(np.concatenate([inter, rng.uniform(0, 5e4, 4000).astype(f),
                                           np.zeros(8, f), [3 * tiny]]))
            u = np.concatenate([uni, uni, uni[:8], [f(2)]]).astype(f)
            want = inter / u > t
        np.testing.assert_array_equal(_cut_over(inter, u, thr), want, err_msg=f"thr={thr}")
    assert (3 * tiny) / f(2) > tiny and _cut(float(tiny))[2]  # the tie, rounded up


@pytest.mark.parametrize("thr", [0.3, 0.45, 0.5, 0.0, -0.25])
@pytest.mark.parametrize("name", MASK_CASES)
def test_mask_replay_equals_iou_matrix(name, thr):
    boxes = _mask_case(name)
    want = (iou_matrix(torch.from_numpy(boxes), torch.from_numpy(boxes)) > thr).numpy()
    got = _mask_replay(boxes, thr)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, got.T)  # the transposed layout holds the same bits
    assert not got[11].any() or name == "seeded"  # the NaN box overlaps nothing


def test_threshold_is_compared_in_float32():
    boxes = _exact_pairs()
    iou = iou_matrix(torch.from_numpy(boxes), torch.from_numpy(boxes))
    for (i, j), thr in (((0, 1), 0.3), ((2, 3), 0.45), ((4, 5), 0.5)):
        assert iou[i, j].item() == np.float32(thr)  # an IoU exactly at f32(thr)
        assert not bool(iou[i, j] > thr) and not _mask_replay(boxes, thr)[i, j]
    assert float(np.float32(0.3)) > 0.3  # a double compare would call it an overlap
    assert _mask_replay(boxes, np.nextafter(np.float32(0.3), np.float32(0)))[0, 1]


def _replay_boxes(boxes: np.ndarray, valid: np.ndarray, thr: float) -> np.ndarray:
    """``nms_keep_boxes`` on the card: the mask pass (i itself cleared;
    tiles without a valid row or column left as garbage), the words in the
    kernel's layout, then the chain, an image at a time."""
    n, k = valid.shape
    upper = ~np.eye(k, dtype=bool)
    return np.stack([
        _chain_pass(_skip_tiles(_words_of(_mask_replay(boxes[i], thr) & upper, k), valid[i]),
                    valid[i])
        for i in range(n)])


def _boxes_inputs(rng, n, k, valid_p, edges=False):
    if edges:
        boxes = np.stack([_edge_boxes(rng, k) for _ in range(n)]) if k >= 12 else None
    else:
        xy = rng.uniform(0, 200, (n, k, 2)).astype(np.float32)
        boxes = np.concatenate([xy, xy + rng.uniform(5, 60, (n, k, 2)).astype(np.float32)], -1)
    return boxes, rng.random((n, k)) < valid_p


@pytest.mark.parametrize("k,valid_p,edges", [
    (1, 1.0, False), (31, 0.9, False), (32, 1.0, True), (33, 0.9, True),
    (512, 0.9, False), (512, 1.0, True), (512, 0.0, False), (1025, 0.9, False),
])
def test_boxes_replay_equals_plain(k, valid_p, edges):
    boxes, valid = _boxes_inputs(np.random.default_rng(k), 2, k, valid_p, edges)
    for thr in (0.3, 0.45):
        want = nms_keep_boxes_plain(torch.from_numpy(boxes), torch.from_numpy(valid), thr)
        np.testing.assert_array_equal(_replay_boxes(boxes, valid, thr), want.numpy())


def test_replay_with_a_valid_prefix():
    """Scores sorted high to low make the valid candidates a prefix, as in
    ``batched_nms``: the tiles past it are skipped (garbage) and change
    nothing."""
    rng = np.random.default_rng(70)
    boxes, valid = _boxes_inputs(rng, 2, 512, 1.0)
    valid[:, 70:] = False
    want = nms_keep_boxes_plain(torch.from_numpy(boxes), torch.from_numpy(valid), 0.45)
    np.testing.assert_array_equal(_replay_boxes(boxes, valid, 0.45), want.numpy())
    ov, _ = _overlaps(rng, 2, 512, 0.02, 1.0)
    ov &= valid[:, :, None] & valid[:, None, :]
    np.testing.assert_array_equal(_replay(ov, valid), _greedy(ov, valid))


# ---------------------------------------------------------------------------
# the chain against the greedy pass


def _chain_replay(ov, valid):
    """The chain on the words of the reference's overlap matrix."""
    k = valid.shape[1]
    return np.stack([_chain_pass(_words_of(ov[i].T, k), valid[i]) for i in range(len(ov))])


@pytest.mark.parametrize("k", [1, 31, 32, 33, 512, 1025])
def test_chain_replay_equals_greedy_seeded(k):
    rng = np.random.default_rng(50 + k)
    ov, valid = _overlaps(rng, 2, k, min(0.5, 3.0 / k), 0.9)
    want = _greedy(ov, valid)
    np.testing.assert_array_equal(_chain_replay(ov, valid), want)
    ov, valid = _chain(1, k)  # every rank overlaps the one before: every other kept
    np.testing.assert_array_equal(_chain_replay(ov, valid)[0], np.arange(k) % 2 == 0)


@settings(max_examples=24, deadline=None, derandomize=True, database=None)
@given(st.sampled_from([1, 31, 32, 33, 512, 1025]), st.floats(0.0, 1.0),
       st.floats(0.0, 1.0), st.integers(0, 2**31))
def test_chain_replay_equals_greedy_drawn(k, p, vp, seed):
    ov, valid = _overlaps(np.random.default_rng(seed), 1, k, p * min(1.0, 8.0 / k), vp)
    np.testing.assert_array_equal(_chain_replay(ov, valid), _greedy(ov, valid))


def test_pack_pass_equals_the_words_of_the_matrix():
    """The pack pass (``nms_keep``) writes the words the mask pass writes
    from the same overlaps, vec and byte reads alike."""
    for k in (48, 45):
        ov, valid = _overlaps(np.random.default_rng(k), 1, k, 0.2, 0.8)
        np.testing.assert_array_equal(_pack_pass(ov[0], k), _words_of(ov[0].T, k))


# ---------------------------------------------------------------------------
# the plain version and the wrappers on the CPU


def test_plain_equals_the_overlap_and_sweeps_of_batched_nms():
    """``nms_keep_boxes_plain`` is the overlap build and sweeps that
    ``batched_nms`` ran inline before B6 took the boxes."""
    rng = np.random.default_rng(9)
    for k, edges in ((300, False), (64, True)):
        boxes, valid = _boxes_inputs(rng, 3, k, 0.8, edges)
        b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
        iou = iou_matrix(b, b)
        rank = torch.arange(k)
        outranked = rank[None, :, None] > rank[None, None, :]
        overlap = (iou > 0.45) & outranked & v[:, None, :] & v[:, :, None]
        want = nms_keep_plain(overlap, v)
        assert torch.equal(nms_keep_boxes_plain(b, v, 0.45), want)
        np.testing.assert_array_equal(want.numpy(), _greedy(overlap.numpy(), valid))


def test_boxes_op_equals_wrapper_and_counts_nothing_on_the_cpu():
    boxes, valid = _boxes_inputs(np.random.default_rng(4), 3, 200, 0.9)
    b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    before = _cuda.LAUNCHES.snapshot()["nms_keep"]
    got = torch.ops.rva.nms_keep_boxes(b, v, 0.45)
    assert got.dtype == torch.bool and got.shape == v.shape
    assert torch.equal(got, nms_keep_boxes(b, v, 0.45))
    with _cuda.through_ops():
        assert torch.equal(nms_keep_boxes(b, v, 0.45), got)
    assert _cuda.LAUNCHES.snapshot()["nms_keep"] == before  # CPU: plain version


def test_scratch_fits_its_budget():
    """The main shape in one pair of launches; N = 32 at K = 8400 in two
    chunks of 16 images, 71 MB of words, under 100 MB."""
    assert mask_words(512) == 32 * 16 * 17 // 2 and scratch_chunk(32, 512) == 32
    assert mask_words(33) == 32 * 3 and mask_words(1) == 32
    assert scratch_chunk(32, 8400) == 16
    assert 16 * mask_words(8400) * 4 <= SCRATCH_BYTES < 100e6
    assert scratch_chunk(3, 200_000) == 1  # one image past the budget still runs
