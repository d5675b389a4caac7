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
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# B3's tensor-core instantiation: what the CUDA kernel consumes, held on the
# CPU (the kernel itself runs only on the card: test_torch_kernels_cuda.py)
# ---------------------------------------------------------------------------

from realtime_analytics_tpu_torch.ops.stem import (  # noqa: E402
    K0_PAD,
    STEM_TILE,
    fused_stem_p1p2_plain,
    pack_w0,
    stem_instantiation,
    stem_smem_bytes,
)


def _torch_stem(rng, c0, c1, dtype):
    p0, p1 = _stem_params(rng, c0, c1)
    return prepare_stem(
        torch.from_numpy(p0["w"]).permute(3, 2, 0, 1) / 255.0, torch.from_numpy(p0["b"]),
        torch.from_numpy(p1["w"]).permute(3, 2, 0, 1), torch.from_numpy(p1["b"]),
        _TORCH[dtype],
    )


@pytest.mark.parametrize("c0,c1", [(16, 32), (32, 64), (48, 96)])
def test_stem_packed_operands_unpack_bit_exact(rng, c0, c1):
    """The bf16 operands of the mma kernel hold the prepared weights bit
    for bit, in the kernel's K order; every padding row is zero."""
    sw = _torch_stem(rng, c0, c1, "bf16")

    def rows_of(w0p):  # [48, c0] -> [ky, 16, c0]: one k-step of 16 per ky
        return w0p.reshape(3, K0_PAD // 3, c0)

    assert sw.w0p.dtype == sw.w1p.dtype == torch.bfloat16
    assert sw.w0p.shape == (K0_PAD, c0) and sw.w1p.shape == (9 * c0, c1)
    assert sw.w0p.is_contiguous() and sw.w1p.is_contiguous()
    assert torch.equal(rows_of(sw.w0p)[:, 1:10].reshape(3, 3, 3, c0).float(), sw.w0)
    assert torch.equal(sw.w1p.float().reshape(3, 3, c0, c1), sw.w1)
    assert not rows_of(sw.w0p)[:, 0].any() and not rows_of(sw.w0p)[:, 10:].any()
    # row ky*16 + 1 + kx*3 + ci is w0[ky, kx, ci]
    assert torch.equal(sw.w0p[16 * 2 + 1 + 3 * 1 + 2].float(), sw.w0[2, 1, 2])
    assert torch.equal(sw.w1p[(3 * 1 + 2) * c0 + 5].float(), sw.w1[1, 2, 5])


def test_stem_packed_operands_only_for_the_mma_kernel(rng):
    assert _torch_stem(rng, 16, 32, "f32").w0p is None
    assert _torch_stem(rng, 8, 24, "bf16").w1p is None


def _silu_round(v, dtype):
    return (v / (1.0 + torch.exp(-v))).to(dtype).float()


def _stem_by_im2col(x, sw):
    """Both convs as plain fp32 matrix products over im2col operands in the
    mma kernel's K order, against its packed operands."""
    n, h, w, _ = x.shape
    h1, w1, h2, w2 = h // 2, w // 2, h // 4, w // 4
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    a0 = torch.zeros(n, h1, w1, K0_PAD)
    for ky in range(3):
        for kx in range(3):
            tap = xp[:, ky:ky + 2 * h1:2, kx:kx + 2 * w1:2]  # [n, h1, w1, 3]
            a0[..., ky * 16 + 1 + kx * 3:ky * 16 + 4 + kx * 3] = tap
    p1 = _silu_round(a0 @ sw.w0p.float() + sw.b0, x.dtype)
    pp = F.pad(p1, (0, 0, 1, 1, 1, 1))
    a1 = torch.cat([pp[:, ky:ky + 2 * h2:2, kx:kx + 2 * w2:2]
                    for ky in range(3) for kx in range(3)], dim=-1)
    return _silu_round(a1 @ sw.w1p.float() + sw.b1, x.dtype)


def _stem_by_tiles(x, sw):
    """The mma kernel's own index arithmetic, tile by tile, in plain
    tensor code: the 72-pixel patch rows that start 8 pixels left of the
    tile, the 16-element K windows at element 14 + 6 j of patch row
    2 r + ky (pad, nine values, pads), the parity-split P1 tile with its
    halo zeroed outside the image, and conv1's taps out of that tile."""
    n, h, w, _ = x.shape
    th, tw = STEM_TILE
    c0, c1 = sw.c0, sw.c1
    h1, w1, h2, w2 = h // 2, w // 2, h // 4, w // 4
    out = torch.zeros(n, h2, w2, c1)
    m = torch.arange((2 * th + 1) * (2 * tw + 1))
    r, j = m // (2 * tw + 1), m % (2 * tw + 1)
    wq, q = torch.meshgrid(torch.arange(th), torch.arange(tw), indexing="ij")
    # x with 3 zero rows above, 8 zero columns left and enough below / right
    xz = F.pad(x.float(), (0, 0, 8, 4 * tw, 3, 4 * th))
    for b in range(n):
        for by in range(-(-h2 // th)):
            for bx in range(-(-w2 // tw)):
                oy0, ox0 = by * th, bx * tw
                py0, px0 = 2 * oy0 - 1, 2 * ox0 - 1
                iy0 = 2 * py0 - 1
                # zero fill outside the image, as the kernel's cp.async does
                patch = xz[b, iy0 + 3:iy0 + 3 + 4 * th + 3,
                           4 * ox0:4 * ox0 + 4 * tw + 8]
                flat = patch.reshape(4 * th + 3, -1)
                a0 = torch.zeros(len(m), K0_PAD)
                for ky in range(3):
                    for e in range(1, 10):  # e = 0 and e >= 10 are masked pads
                        a0[:, ky * 16 + e] = flat[2 * r + ky, 14 + 6 * j + e]
                p1 = _silu_round(a0 @ sw.w0p.float() + sw.b0, x.dtype)
                gy, gx = py0 + r, px0 + j
                inside = (gy >= 0) & (gy < h1) & (gx >= 0) & (gx < w1)
                p1 = torch.where(inside[:, None], p1, torch.zeros(()))
                split = torch.zeros(2 * th + 1, 2, tw + 1, c0)
                split[r, j & 1, j >> 1] = p1
                a1 = torch.cat([split[2 * wq + ky, kx & 1, q + (kx >> 1)]
                                for ky in range(3) for kx in range(3)], dim=-1)
                tile = _silu_round(a1 @ sw.w1p.float() + sw.b1, x.dtype)
                hh, ww = min(th, h2 - oy0), min(tw, w2 - ox0)
                out[b, oy0:oy0 + hh, ox0:ox0 + ww] = tile[:hh, :ww]
    return out


@pytest.mark.parametrize("emulate", [_stem_by_im2col, _stem_by_tiles],
                         ids=["im2col", "tiles"])
@pytest.mark.parametrize("n,h,w,c0,c1", [(2, 64, 64, 16, 32), (2, 68, 36, 32, 64)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stem_kernel_operands_match_plain(rng, emulate, dtype, n, h, w, c0, c1):
    """K ordering, padding and halo arithmetic of the mma kernel against
    the plain version. The operands are the bf16-packed ones in both dtype
    cases; with fp32 activations only the order of the sums differs (atol
    1e-4), with bf16 activations one P1 rounding may flip (1% of range)."""
    sw = _torch_stem(rng, c0, c1, "bf16")
    x = torch.from_numpy(rng.integers(0, 256, (n, h, w, 3)).astype(np.float32))
    x = x.to(_TORCH[dtype])
    want = fused_stem_p1p2_plain(x, sw).float()
    got = emulate(x, sw)
    assert got.shape == want.shape == (n, h // 4, w // 4, c1)
    err = (got - want).abs().max().item()
    tol = 1e-4 if dtype == "f32" else 1e-2 * want.abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("dtype,c0,c1,w,want", [
    ("bf16", 16, 32, 640, "mma"),       # v8n main path
    ("bf16", 32, 64, 640, "mma"),       # v8s
    ("bf16", 48, 96, 640, "mma"),       # v8m: only the mma plan fits
    ("bf16", 8, 24, 64, "general"),     # widths off the fragment multiples
    ("f32", 16, 32, 640, "general"),    # exact fp32 products
    ("bf16", 16, 32, 644, "general"),   # rows of W*6 bytes not 16-byte aligned
    ("bf16", 80, 160, 640, None),       # neither plan fits one block
    ("f32", 48, 96, 640, None),
])
def test_stem_instantiation(dtype, c0, c1, w, want):
    assert stem_instantiation(_TORCH[dtype], c0, c1, w) == want


def test_stem_smem_plans():
    """The plans csrc/stem.cu computes for itself (mma_plan,
    general_smem_bytes), at the widths the card runs."""
    assert stem_smem_bytes(16, 32, "mma") == 35 * 432 + 17 * 34 * 48 + 144 * 80
    assert stem_smem_bytes(32, 64, "mma") == 128 * 144 + 17 * 34 * 80 + 288 * 144
    assert stem_smem_bytes(16, 24, "mma") == 35 * 432 + 17 * 34 * 48 + 144 * 48
    assert stem_smem_bytes(16, 32) == 4 * (7140 + 27 * 16 + 9 * 16 * 32 + 48 + 17 * 584)
    assert stem_smem_bytes(32, 64) == 4 * (7140 + 27 * 32 + 9 * 32 * 64 + 96 + 17 * 1128)
    assert stem_smem_bytes(6, 10) == 4 * (7140 + 27 * 8 + 9 * 6 * 16 + 24 + 17 * 248)
    assert stem_geometry_ok(640, 640, 48, 96, torch.bfloat16)
    assert not stem_geometry_ok(640, 640, 48, 96)
