"""Plain versions of kernels B2 (head decode) and B3 (fused stem) against
the JAX package's Pallas kernels in interpret mode, on the CPU.

Cases follow tests/test_pallas_decode.py and tests/test_pallas_stem.py.
Tolerances: B2 boxes atol 1e-4 px (f32 softmax expectation, summation
order only), conf atol 1e-6, cls exact (first-index ties); B3 fp32 atol
1e-4 and bf16 at test_pallas_stem.py's relative bound 2e-2 (P1 is rounded
to bf16 in both, so one rounding flip moves a few outputs by a bf16 ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_analytics_tpu.ops.pallas_decode import decode_v8_level as j_decode
from realtime_analytics_tpu.ops.pallas_stem import fused_stem_p1p2 as j_stem
from realtime_analytics_tpu.ops.pallas_stem import stem_geometry_ok as j_stem_ok
from realtime_analytics_tpu_torch.ops.decode import decode_v8_level
from realtime_analytics_tpu_torch.ops.stem import (
    fused_stem_p1p2,
    prepare_stem,
    stem_geometry_ok,
)

_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
_JAX = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _decode_pair(box, cls, dtype, stride=8.0):
    jb = jnp.asarray(box).astype(_JAX[dtype])
    jc = jnp.asarray(cls).astype(_JAX[dtype])
    want = [np.asarray(a) for a in j_decode(jb, jc, stride=stride, interpret=True)]
    tb = torch.from_numpy(box).to(_TORCH[dtype])
    tc = torch.from_numpy(cls).to(_TORCH[dtype])
    got = [a.numpy() for a in decode_v8_level(tb, tc, stride=stride)]
    return got, want


@pytest.mark.parametrize("h,w,nc,dtype", [
    (8, 8, 80, "bf16"), (4, 6, 17, "bf16"), (2, 2, 3, "bf16"), (8, 8, 80, "f32"),
    (20, 20, 80, "bf16"),
])
def test_decode_plain_matches_pallas(rng, h, w, nc, dtype):
    box = rng.normal(0, 3, (2, h, w, 64)).astype(np.float32)
    cls = rng.normal(0, 3, (2, h, w, nc)).astype(np.float32)
    got, want = _decode_pair(box, cls, dtype)
    np.testing.assert_allclose(got[0], want[0], atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2].dtype == np.int32


def test_decode_plain_ties_break_first(rng):
    """Deliberately tied class logits: the lowest class id wins, in both."""
    box = rng.normal(0, 1, (1, 4, 4, 64)).astype(np.float32)
    cls = np.zeros((1, 4, 4, 80), np.float32)
    cls[0, 1, 1, [5, 9, 40]] = 2.0      # three-way tie at the max
    cls[0, 2, 3, [79, 3]] = 1.5
    got, want = _decode_pair(box, cls, "bf16")
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2][0, 0] == 0 and got[2][0, 5] == 5 and got[2][0, 11] == 3


def test_decode_plain_extreme_logits(rng):
    box = rng.normal(0, 1, (1, 4, 4, 64)).astype(np.float32)
    box[0, 0, 0, :16] = -100.0
    box[0, 0, 0, 0] = 100.0
    cls = np.zeros((1, 4, 4, 80), np.float32)
    got, want = _decode_pair(box, cls, "bf16")
    np.testing.assert_allclose(got[0], want[0], atol=1e-3)


def _stem_params(rng, c0, c1):
    return (
        {"w": rng.normal(size=(3, 3, 3, c0)).astype(np.float32) * 0.2,
         "b": rng.normal(size=(c0,)).astype(np.float32)},
        {"w": rng.normal(size=(3, 3, c0, c1)).astype(np.float32) * 0.2,
         "b": rng.normal(size=(c1,)).astype(np.float32)},
    )


def _run_stems(p0, p1, x, dtype):
    jp0 = {k: jnp.asarray(v).astype(_JAX[dtype]) for k, v in p0.items()}
    jp1 = {k: jnp.asarray(v).astype(_JAX[dtype]) for k, v in p1.items()}
    want = np.asarray(
        j_stem(jnp.asarray(x).astype(_JAX[dtype]), jp0, jp1, interpret=True)
        .astype(jnp.float32)
    )
    sw = prepare_stem(
        torch.from_numpy(p0["w"]).permute(3, 2, 0, 1), torch.from_numpy(p0["b"]),
        torch.from_numpy(p1["w"]).permute(3, 2, 0, 1), torch.from_numpy(p1["b"]),
        _TORCH[dtype],
    )
    got = fused_stem_p1p2(torch.from_numpy(x).to(_TORCH[dtype]), sw)
    assert got.dtype == _TORCH[dtype]
    return got.float().numpy(), want


@pytest.mark.parametrize("h,w,c0,c1", [
    (32, 32, 16, 32), (128, 128, 16, 32), (64, 32, 32, 64), (48, 64, 16, 32),
])
def test_stem_plain_matches_pallas_f32(h, w, c0, c1):
    rng = np.random.default_rng(0)
    p0, p1 = _stem_params(rng, c0, c1)
    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    assert stem_geometry_ok(h, w, c0, c1) and j_stem_ok(h, w, c0, c1)
    got, want = _run_stems(p0, p1, x, "f32")
    assert got.shape == want.shape == (2, h // 4, w // 4, c1)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_stem_plain_matches_pallas_bf16():
    rng = np.random.default_rng(1)
    p0, p1 = _stem_params(rng, 16, 32)
    x = rng.uniform(0, 255, size=(2, 64, 64, 3)).astype(np.float32)
    got, want = _run_stems(p0, p1, x, "bf16")
    rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert rel < 2e-2, rel


def test_stem_geometry_gate():
    assert not stem_geometry_ok(30, 32, 16, 32)   # H % 4
    assert not stem_geometry_ok(32, 34, 16, 32)   # W % 4
    assert stem_geometry_ok(640, 640, 16, 32)     # v8n serving shape
    assert stem_geometry_ok(640, 640, 32, 64)     # v8s
    assert stem_geometry_ok(64, 64, 8, 24)        # no 128-lane / c1 == 2*c0 rule
    assert not stem_geometry_ok(640, 640, 80, 160)  # shared memory plan too big
