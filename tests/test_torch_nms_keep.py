"""Kernel B6 (``csrc/nms.cu``, ``ops/nms.nms_keep``): greedy NMS's keep pass.

The kernel runs only on the card; here its plain version (the fixpoint
sweeps the port ran before) is held against a greedy pass in rank order on
seeded and hypothesis-drawn overlaps, and a numpy replay of the kernel's
own arithmetic (bool bytes packed to words four at a time, the words left
of the diagonal, one vote a rank, the owner lane's bit) against the plain
version. Every comparison is bit for bit: the keep mask is boolean and the
greedy pass is the fixpoint's unique solution. ``batched_nms`` through the
registered op equals ``batched_nms`` through the wrapper, and a trace keeps
the op as one node with no ``aten.equal`` left (the sweeps' host test).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from realtime_analytics_tpu_torch.ops import _cuda
from realtime_analytics_tpu_torch.ops.nms import (
    SMEM_ROWS,
    batched_nms,
    nms_keep,
    nms_keep_plain,
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


def _replay(ov: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The kernel, thread for thread: phase 1 packs the words q <= i / 32 of
    each row (the others stay unread); phase 2, one warp: lane l holds the
    keep words l, l + 32, ...; a valid rank i is suppressed when any lane's
    word of row i meets its keep word (``__any_sync``); else the lane owning
    word i / 32 sets bit i % 32; phase 3 unpacks."""
    n, k = valid.shape
    words = -(-k // 32)
    wpl = -(-words // 32)  # keep words a lane
    vec = k % 16 == 0
    keep = np.zeros((n, k), bool)
    for img in range(n):
        bits = {}
        for i in range(k):
            for q in range(words):
                if q <= i >> 5:
                    bits[i, q] = _pack_word(ov[img, i].view(np.uint8), q, k, vec)
        kept = np.zeros((32, wpl), np.uint64)
        for i in range(k):
            if not valid[img, i]:
                continue
            qmax = i >> 5
            hit = any((bits[i, w * 32 + lane] & int(kept[lane, w])) != 0
                      for lane in range(32) for w in range(wpl) if w * 32 + lane <= qmax)
            if not hit:
                kept[qmax & 31, qmax >> 5] |= np.uint64(1 << (i & 31))
        for lane in range(32):
            for w in range(wpl):
                c0 = (w * 32 + lane) * 32
                for b in range(32):
                    if c0 + b < k:
                        keep[img, c0 + b] = bool((int(kept[lane, w]) >> b) & 1)
    return keep


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

    class Step(torch.nn.Module):
        def forward(self, b, s, c):
            with _cuda.through_ops():
                return batched_nms(b, s, c, iou_threshold=0.45, max_det=100, pre_topk=256)

    ep = torch.export.export(Step(), (boxes, scores, cls), strict=False)
    targets = [str(node.target) for node in ep.graph.nodes if node.op == "call_function"]
    assert targets.count("rva.nms_keep.default") == 1
    assert targets.count("rva.row_gather.default") == 2
    assert not any("equal" in t for t in targets)
    for a, b in zip(ep.module()(boxes, scores, cls), Step()(boxes, scores, cls)):
        assert torch.equal(a, b)
