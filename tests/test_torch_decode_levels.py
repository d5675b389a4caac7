"""Kernel B2's whole-head form (``decode_v8_levels``) on the CPU.

(a) ``decode_v8_levels_plain`` against the JAX package's Pallas kernel in
interpret mode, level by level, concatenated on axis 1: boxes atol 1e-3 px,
conf atol 1e-5, class ids equal (the bounds the port holds B2 to on the
card; the f32 softmax expectation differs by summation order only).
(b) and (c): csrc/decode.cu runs only on the card
(tests/test_torch_kernels_cuda.py), so its index arithmetic is replayed
here in numpy, thread for thread: the level lookup from the block index,
the lane -> (anchor, box side, class chunks) map, the lanes' strict scans
and the shuffle merge that lets the lower index win an equal maximum, and
the index each result is written to. The replay must give the plain
version's results and hit every slot of the concatenated outputs once.
(d) the instantiation pickers; (f) the model with ``pallas_decode`` on
against off.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_analytics_tpu.ops.pallas_decode import decode_v8_level as j_decode
from realtime_analytics_tpu_torch.ops import _cuda
from realtime_analytics_tpu_torch.ops.decode import (
    BLOCK_ANCHORS,
    LANES,
    MAX_LEVELS,
    REG_MAX,
    _Levels,
    _geometry,
    decode_instantiation,
    decode_v8_level,
    decode_v8_level_plain,
    decode_v8_levels,
    decode_v8_levels_plain,
    level_table,
)

_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
_JAX = {"f32": jnp.float32, "bf16": jnp.bfloat16}
CLS_BATCH = 3  # class loads a lane issues at once (csrc/decode.cu kClsBatch)
NO_CLASS = np.iinfo(np.int32).max


def _head(rng, n, shapes, nc, dtype="f32"):
    """Seeded logits of a head, rounded to ``dtype`` and kept as fp32."""
    levels = []
    for h, w in shapes:
        box = torch.from_numpy(rng.normal(0, 3, (n, h, w, 64)).astype(np.float32))
        cls = torch.from_numpy(rng.normal(0, 3, (n, h, w, nc)).astype(np.float32))
        levels.append((box.to(_TORCH[dtype]), cls.to(_TORCH[dtype])))
    return levels


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("shapes", [((8, 8), (4, 4), (2, 2)), ((8, 6), (4, 3), (2, 5))],
                         ids=["square", "ragged"])
def test_levels_plain_matches_pallas(rng, shapes, dtype):
    strides = (8.0, 16.0, 32.0)
    levels = _head(rng, 2, shapes, 80, dtype)
    want = [[], [], []]
    for (box, cls), stride in zip(levels, strides):
        jb = jnp.asarray(box.float().numpy()).astype(_JAX[dtype])
        jc = jnp.asarray(cls.float().numpy()).astype(_JAX[dtype])
        for part, arr in zip(want, j_decode(jb, jc, stride=stride, interpret=True)):
            part.append(np.asarray(arr))
    want = [np.concatenate(part, axis=1) for part in want]
    before = _cuda.LAUNCHES.snapshot()["decode_v8"]
    got = [a.numpy() for a in decode_v8_levels(levels, strides)]
    assert _cuda.LAUNCHES.snapshot()["decode_v8"] == before  # CPU: plain version
    anchors = sum(h * w for h, w in shapes)
    assert got[0].shape == (2, anchors, 4) and got[1].shape == got[2].shape == (2, anchors)
    np.testing.assert_allclose(got[0], want[0], atol=1e-3)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2].dtype == np.int32


def test_levels_plain_is_the_levels_concatenated(rng):
    levels = _head(rng, 2, ((4, 6), (2, 3)), 17)
    got = decode_v8_levels_plain(levels, (8.0, 16.0))
    parts = [decode_v8_level_plain(b, c, stride=s) for (b, c), s in zip(levels, (8.0, 16.0))]
    for g, *p in zip(got, *parts):
        assert torch.equal(g, torch.cat(p, dim=1))
    one = decode_v8_level(*levels[0], stride=8.0)
    for g, p in zip(one, parts[0]):
        assert torch.equal(g, p)


# ---------------------------------------------------------------------------
# the kernel's index arithmetic, replayed
# ---------------------------------------------------------------------------


def _ahead(ov, oi, bv, bi):
    """csrc/decode.cu ``ahead``: the greater logit, NaN above all; on equal
    logits the lower index."""
    on, bn = np.isnan(ov), np.isnan(bv)
    with np.errstate(invalid="ignore"):
        plain = (ov > bv) | ((ov == bv) & (oi < bi))
    return np.where(on | bn, on & (~bn | (oi < bi)), plain)


def _lane_classes(s, chunks, kvec):
    """Class indices lane ``s`` scans, in its order: chunks s, s + 4, ...
    dealt in batches of CLS_BATCH."""
    out = []
    for first in range(s, chunks, CLS_BATCH * LANES):
        for j in range(CLS_BATCH):
            c = first + j * LANES
            if c < chunks:
                out += range(c * kvec, (c + 1) * kvec)
    return out


def _replay_class_reduce(rows, kvec):
    """(max logit, first maximal class) of each row of ``rows`` [R, nc] by
    the kernel's four lanes: strict scans, then the xor-shuffle merge."""
    nc = rows.shape[1]
    assert nc % kvec == 0
    chunks = nc // kvec
    best = np.full((LANES, len(rows)), -np.inf, np.float32)
    arg = np.empty((LANES, len(rows)), np.int64)
    for s in range(LANES):
        arg[s] = s * kvec if s < chunks else NO_CLASS
        for c in _lane_classes(s, chunks, kvec):
            x = rows[:, c]
            with np.errstate(invalid="ignore"):
                take = (x > best[s]) | (np.isnan(x) & ~np.isnan(best[s]))
            best[s] = np.where(take, x, best[s])
            arg[s] = np.where(take, c, arg[s])
    for d in (1, 2):
        ov, oi = best[[s ^ d for s in range(LANES)]], arg[[s ^ d for s in range(LANES)]]
        take = _ahead(ov, oi, best, arg)
        best, arg = np.where(take, ov, best), np.where(take, oi, arg)
    for s in range(1, LANES):  # every lane of the group ends with one answer
        np.testing.assert_array_equal(arg[s], arg[0])
        np.testing.assert_array_equal(best[s], best[0])
    return best[0], arg[0]


def test_lane_map_deals_every_class_once():
    for nc, kvec in [(80, 8), (80, 4), (81, 1), (3, 1), (8, 8), (104, 8), (200, 4)]:
        chunks = nc // kvec
        dealt = [_lane_classes(s, chunks, kvec) for s in range(LANES)]
        assert sorted(c for lane in dealt for c in lane) == list(range(nc))
        for s, lane in enumerate(dealt):
            assert lane == sorted(lane)  # a lane scans in index order: strict > suffices
            assert all((c // kvec) % LANES == s for c in lane)
    # nc = 80 in bf16: chunks dealt 3, 3, 2, 2, all in a lane's first batch
    assert [len(_lane_classes(s, 10, 8)) // 8 for s in range(LANES)] == [3, 3, 2, 2]


@pytest.mark.parametrize("nc,kvec", [(80, 8), (80, 4), (81, 1), (3, 1), (2, 1), (8, 8),
                                     (104, 8), (200, 4), (17, 1)])
def test_class_reduce_replay_matches_argmax(rng, nc, kvec):
    rows = rng.normal(0, 3, (400, nc)).astype(np.float32)
    rows[:50] = np.round(rows[:50])          # many ties at the maximum
    rows[50] = 0.0                           # every class tied: class 0
    rows[51] = -np.inf                       # likewise at -inf
    rows[52, :] = -1.0
    rows[52, [nc - 1, nc // 2]] = 4.0        # a tie that ends in the last chunk
    if nc > 8:
        rows[53, :] = -1.0
        rows[53, [7, 8]] = 2.0               # a tie across two lanes' chunks
        rows[54, :] = 1.0
        rows[54, [nc - 2]] = np.nan          # NaN is the greatest
        rows[55, [3, nc - 1]] = np.nan       # the first NaN wins
        rows[56, 5] = np.inf
    best, arg = _replay_class_reduce(rows, kvec)
    t = torch.from_numpy(rows)
    np.testing.assert_array_equal(arg, t.argmax(dim=-1).numpy())
    np.testing.assert_array_equal(best, t.amax(dim=-1).numpy())
    assert arg[50] == 0 and arg[51] == 0 and arg[52] == nc // 2


def _replay_decode(levels, strides, kvec):
    """The whole kernel in numpy: every block and thread of the launch
    finds its level, anchor and side as csrc/decode.cu does and writes
    where it writes. Returns the outputs and how often each slot was
    written."""
    n, nc = levels[0][0].shape[0], levels[0][1].shape[-1]
    t, address, n_, anchors = _geometry(tuple(b.shape for b, _ in levels), tuple(strides))
    assert address == ctypes.addressof(t) and (n_, anchors) == (t.n, t.anchors)
    assert t.count == len(levels) and t.n == n
    total = n * t.anchors
    boxes = np.zeros((total, 4), np.float32)
    conf, cid = np.zeros(total, np.float32), np.zeros(total, np.int32)
    hits = np.zeros((total, LANES), np.int64)
    blocks = t.block0[t.count]
    block = np.repeat(np.arange(blocks), BLOCK_ANCHORS)
    slot = np.tile(np.arange(BLOCK_ANCHORS), blocks)  # threadIdx.x / LANES
    lvl = np.zeros_like(block)
    for i in range(1, MAX_LEVELS):
        lvl = np.where((i < t.count) & (block >= t.block0[i]), i, lvl)
    for l, ((box, cls), stride) in enumerate(zip(levels, strides)):
        h, w = t.h[l], t.w[l]
        a = (block[lvl == l] - t.block0[l]) * BLOCK_ANCHORS + slot[lvl == l]
        a = a[a < n * h * w]  # the others return
        img, cell = a // (h * w), a % (h * w)
        gy, gx = cell // w, cell % w
        out = img * t.anchors + t.offset[l] + cell
        v = box.float().numpy().reshape(-1, LANES, REG_MAX)[a]  # lane s: 16 bins of side s
        e = np.exp2((v - v.max(-1, keepdims=True)) * np.float32(1.4426950408889634))
        dist = (e * np.arange(REG_MAX, dtype=np.float32)).sum(-1) / e.sum(-1)
        for s in range(LANES):
            g = (gy if s & 1 else gx).astype(np.float32) + np.float32(0.5)
            side = g - dist[:, s] if s < 2 else g + dist[:, s]
            boxes[out, s] = side * np.float32(t.stride[l])
            hits[out, s] += 1
        best, arg = _replay_class_reduce(cls.float().numpy().reshape(-1, nc)[a], kvec)
        conf[out] = 1.0 / (1.0 + np.exp(-best))
        cid[out] = arg
    return (boxes.reshape(n, -1, 4), conf.reshape(n, -1), cid.reshape(n, -1)), hits


@pytest.mark.parametrize("n,shapes,nc,kvec", [
    (2, ((8, 8), (4, 4), (2, 2)), 80, 8),    # three levels, 16-byte bf16 loads
    (3, ((5, 7), (3, 2)), 80, 4),            # ragged levels: partly filled blocks
    (1, ((9, 9), (4, 5), (3, 3), (1, 2)), 17, 1),  # four levels, element loads
    (5, ((3, 3),), 3, 1),                    # one level: decode_v8_level's case
])
def test_kernel_replay_matches_plain_and_fills_every_slot_once(rng, n, shapes, nc, kvec):
    strides = [8.0, 16.0, 32.0, 64.0][:len(shapes)]
    levels = _head(rng, n, shapes, nc, "bf16")
    levels[0][1][:, 0] = 0.0          # a row of anchors with every class tied
    got, hits = _replay_decode(levels, strides, kvec)
    want = decode_v8_levels_plain(levels, strides)
    assert (hits == 1).all()          # each (image, level, cell, side) exactly once
    np.testing.assert_allclose(got[0], want[0].numpy(), atol=1e-3)
    np.testing.assert_allclose(got[1], want[1].numpy(), atol=1e-5)
    np.testing.assert_array_equal(got[2], want[2].numpy())


@pytest.mark.parametrize("n,shapes", [
    (32, ((80, 80), (40, 40), (20, 20))), (2, ((8, 8), (4, 4), (2, 2))),
    (3, ((5, 7), (3, 2))), (1, ((1, 1),)), (7, ((9, 9), (4, 5), (3, 3), (1, 2))),
])
def test_level_table_lands_on_the_concatenation(n, shapes):
    table = level_table(n, shapes)
    assert table.anchors == sum(h * w for h, w in shapes)
    assert table.offsets[0] == 0 and table.block0[0] == 0
    # where torch.cat(dim=1) puts (image, level, cell)
    ids = [torch.arange(n * h * w).reshape(n, h * w) + 10**6 * l
           for l, (h, w) in enumerate(shapes)]
    want = torch.cat(ids, dim=1).reshape(-1).numpy()
    got = np.full(n * table.anchors, -1, np.int64)
    for l, (h, w) in enumerate(shapes):
        blocks = table.block0[l + 1] - table.block0[l]
        assert blocks == -(-n * h * w // BLOCK_ANCHORS)  # whole blocks, none spare
        a = np.arange(blocks * BLOCK_ANCHORS)
        a = a[a < n * h * w]
        out = (a // (h * w)) * table.anchors + table.offsets[l] + a % (h * w)
        assert (got[out] == -1).all()  # no slot written twice
        got[out] = a + 10**6 * l
    np.testing.assert_array_equal(got, want)
    if n == 32 and len(shapes) == 3:  # the main path: 8400 anchors, 4200 blocks
        assert table == ((0, 6400, 8000), (0, 3200, 4000, 4200), 8400)


@pytest.mark.parametrize("dtype,nc,aligned,want", [
    (torch.bfloat16, 80, True, "vec16"),    # the main path
    (torch.float32, 80, True, "vec16"),
    (torch.bfloat16, 80, False, "element"),  # a view that starts off a 16-byte line
    (torch.bfloat16, 84, True, "element"),   # nc % 8
    (torch.float32, 84, True, "vec16"),      # nc % 4 is enough in fp32
    (torch.float32, 81, True, "element"),
    (torch.bfloat16, 3, True, "element"),
    (torch.bfloat16, 8, True, "vec16"),
    (torch.float16, 80, True, None),
    (torch.float64, 80, True, None),
])
def test_decode_instantiation(dtype, nc, aligned, want):
    assert decode_instantiation(dtype, nc, aligned) == want


def test_launch_table_mirrors_the_level_table():
    shapes, strides = ((80, 80), (40, 40), (20, 20)), (8, 16, 32)
    t = _geometry(tuple(torch.Size((32, h, w, 64)) for h, w in shapes), strides)[0]
    table = level_table(32, shapes)
    assert list(t.h[:3]) == [80, 40, 20] and list(t.w[:3]) == [80, 40, 20]
    assert list(t.stride[:3]) == list(strides)
    assert tuple(t.offset[:3]) == table.offsets and tuple(t.block0[:4]) == table.block0
    assert (t.count, t.anchors, t.n) == (3, 8400, 32)
    assert not any(t.box) and not any(t.cls)  # a launch passes its pointers as arguments
    # two arrays of 4 pointers, four of 4 ints or floats, block0 of 5, three ints
    assert ctypes.sizeof(_Levels) == 2 * 32 + 4 * 16 + 20 + 12


def test_levels_wrapper_rejects_what_it_does_not_take(rng):
    levels = _head(rng, 1, ((2, 2),) * 5, 8)
    with pytest.raises(ValueError):  # off the CPU and not on a card: raises, no plain version
        decode_v8_levels([(levels[0][0].to("meta"), levels[0][1].to("meta"))], [8.0])
    with pytest.raises(ValueError):
        decode_v8_levels([], [])
    # CPU tensors take the plain version whatever their count
    assert decode_v8_levels(levels, [8.0] * 5)[0].shape == (1, 20, 4)
    # the launch table is refused where the kernel could not take it
    sizes = tuple(torch.Size((1, 2, 2, 64)) for _ in range(5))
    with pytest.raises(ValueError, match="1 to 4 levels"):
        _geometry(sizes, (8.0,) * 5)
    with pytest.raises(ValueError, match="stride for"):
        _geometry(sizes[:2], (8.0,))
    with pytest.raises(ValueError, match="differ in N"):
        _geometry((torch.Size((1, 2, 2, 64)), torch.Size((2, 1, 1, 64))), (8.0, 16.0))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_model_decode_on_equals_off(dtype):
    """``pallas_decode`` on against off on the CPU: the wrapper takes the
    plain version there, so the outputs are equal bit for bit; and the
    unreduced path's boxes are the reduced path's."""
    from realtime_analytics_tpu_torch.models.weights import params_from_jax, synthetic_params
    from realtime_analytics_tpu_torch.models.yolo import build_yolo

    model = build_yolo("yolov8", "n", 80)
    model = params_from_jax(model, synthetic_params(model, seed=0)).eval()
    model = model.to(dtype=_TORCH[dtype], memory_format=torch.channels_last)
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (2, 64, 96, 3))
                         .astype(np.float32)).to(_TORCH[dtype])
    outs = {}
    with torch.inference_mode():
        for mode in ("off", "on"):
            model.pallas_decode = mode
            outs[mode] = model(x, reduce_scores=True)
        full = model(x, reduce_scores=False)
    anchors = 8 * 12 + 4 * 6 + 2 * 3
    assert outs["on"]["boxes_xyxy"].shape == (2, anchors, 4)
    for key in ("boxes_xyxy", "conf", "cls"):
        assert torch.equal(outs["on"][key], outs["off"][key])
    assert torch.equal(full["boxes_xyxy"], outs["on"]["boxes_xyxy"])
    assert full["scores"].shape == (2, anchors, 80)
    torch.testing.assert_close(full["scores"].amax(-1), outs["on"]["conf"], atol=1e-6, rtol=0)
