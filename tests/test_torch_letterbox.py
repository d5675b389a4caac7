"""Kernel B4 (bilinear letterbox / stretch resize) on the CPU.

The port's plain B4 (``ops/letterbox.py``: ``letterbox_plain`` and
``stretch_resize_plain``, which the wrappers take for CPU tensors) against
the JAX package's Pallas kernel run in interpret mode
(``pallas_letterbox`` / ``pallas_stretch_resize``, ``interpret=True``), on
seeded numpy frames, in each H mode of the TPU kernel (select, mean2,
matmul) and for the stretch, in fp32 and bf16.

Tolerance: the JAX package's own for its kernel
(tests/test_pallas_preprocess.py): max |delta| <= 3.01/255 and under 2% of
the pixels beyond 1.01/255 — the TPU kernel rounds its weights and its
H-pass to bf16, the port keeps both in fp32, so a value near a .5 level
boundary may round to the neighbouring level. The pad is 114/255.

The CUDA kernel itself runs only on the card (tests/test_torch_kernels_cuda.py).
Here its tables are checked: ``bilinear_taps`` rebuilds the JAX package's
``bilinear_matrix`` exactly, and an emulation of the kernel's arithmetic as
csrc/letterbox.cu writes it (per output pixel, H then W in fp32, round half
up) equals the plain version bit for bit; at the integer ratios (select,
mean2) both also equal ``preprocess_batch``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from realtime_analytics_tpu.ops.pallas_preprocess import (
    _h_mode,
    bilinear_matrix,
    pallas_letterbox,
    pallas_stretch_resize,
)
from realtime_analytics_tpu.ops.preprocess import letterbox_spec as jax_letterbox_spec
from realtime_analytics_tpu_torch.ops import _cuda
from realtime_analytics_tpu_torch.ops.letterbox import (
    _tables,
    bilinear_taps,
    letterbox,
    letterbox_plain,
    stretch_resize,
    stretch_resize_plain,
    stretch_spec,
)
from realtime_analytics_tpu_torch.ops.preprocess import letterbox_spec, preprocess_batch

PAD = 114.0 / 255.0
# (source H, W) -> 128x128 letterbox, and the H mode the TPU kernel takes
LETTERBOX_CASES = [((360, 640), "select"), ((288, 512), "mean2"),
                   ((300, 500), "matmul"), ((75, 131), "matmul")]
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _frames(src_hw, n=2, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *src_hw, 3), dtype=np.uint8)


def _hold(got, want):
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert diff.max() <= 3.01 / 255.0, diff.max()
    assert np.mean(diff > 1.01 / 255.0) < 0.02


@pytest.mark.parametrize("src_hw,mode", LETTERBOX_CASES)
@pytest.mark.parametrize("dtypes", DTYPES, ids=["fp32", "bf16"])
def test_letterbox_matches_jax_kernel(src_hw, mode, dtypes):
    t_dtype, j_dtype = dtypes
    frames = _frames(src_hw)
    spec = letterbox_spec(src_hw, (128, 128))
    assert _h_mode(jax_letterbox_spec(src_hw, (128, 128)))[0] == mode
    want = np.asarray(pallas_letterbox(
        jnp.asarray(frames), spec=jax_letterbox_spec(src_hw, (128, 128)),
        out_dtype=j_dtype, interpret=True,
    ).astype(jnp.float32))
    before = _cuda.LAUNCHES.snapshot()["letterbox"]
    got = letterbox(torch.from_numpy(frames), spec, t_dtype)
    assert _cuda.LAUNCHES.snapshot()["letterbox"] == before  # CPU: plain version
    assert got.dtype == t_dtype and got.shape == (2, 128, 128, 3)
    got = got.float().numpy()
    _hold(got, want)
    pad = np.ones(got.shape[1:3], bool)
    pad[spec.pad_top:spec.pad_top + spec.new_h, spec.pad_left:spec.pad_left + spec.new_w] = False
    if pad.any():
        pad_value = torch.tensor(PAD, dtype=t_dtype).float().item()
        np.testing.assert_allclose(got[:, pad], pad_value, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtypes", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("src_hw,dst_hw", [((90, 160), (64, 64)), ((48, 40), (64, 64))])
def test_stretch_resize_matches_jax_kernel(dtypes, src_hw, dst_hw):
    t_dtype, j_dtype = dtypes
    frames = _frames(src_hw, seed=1)
    want = np.asarray(pallas_stretch_resize(
        jnp.asarray(frames), dst_hw, out_dtype=j_dtype, interpret=True,
    ).astype(jnp.float32))
    got = stretch_resize(torch.from_numpy(frames), dst_hw, t_dtype)
    assert got.shape == (2, *dst_hw, 3) and got.dtype == t_dtype
    _hold(got.float().numpy(), want)
    torch.testing.assert_close(got, stretch_resize_plain(torch.from_numpy(frames), dst_hw,
                                                         t_dtype), atol=0, rtol=0)


@pytest.mark.parametrize("src,dst", [(540, 360), (1080, 640), (1080, 224), (97, 128),
                                     (64, 64), (720, 360), (1520, 640)])
def test_bilinear_taps_rebuild_the_jax_matrix(src, dst):
    i0, i1, w = bilinear_taps(src, dst)
    a = np.zeros((dst, src), np.float64)
    np.add.at(a, (np.arange(dst), i0), 1.0 - w.astype(np.float64))
    np.add.at(a, (np.arange(dst), i1), w.astype(np.float64))
    np.testing.assert_allclose(a, bilinear_matrix(src, dst), atol=1e-6, rtol=0)
    assert (i0 >= 0).all() and (i1 < src).all() and ((w >= 0) & (w < 1)).all()


def _emulate_kernel(frames, spec):
    """csrc/letterbox.cu's arithmetic on its tables, in fp32 (float32
    output, before the cast)."""
    taps, weights = _tables(spec, torch.device("cpu"))
    nh, nw = spec.new_h, spec.new_w
    y0, y1 = taps[:nh].long(), taps[nh:2 * nh].long()
    x0, x1 = taps[2 * nh:2 * nh + nw].long(), taps[2 * nh + nw:].long()
    wy, wx = weights[:nh, None, None], weights[nh:, None]
    p = torch.from_numpy(frames).float()
    r0, r1 = p[:, y0], p[:, y1]  # [N, nh, W, 3]
    ha = (1 - wy) * r0[:, :, x0] + wy * r1[:, :, x0]
    hb = (1 - wy) * r0[:, :, x1] + wy * r1[:, :, x1]
    r = torch.floor((1 - wx) * ha + wx * hb + 0.5).clamp(0, 255) * (1.0 / 255.0)
    out = torch.full((len(frames), spec.dst_h, spec.dst_w, 3), 114.0) * (1.0 / 255.0)
    out[:, spec.pad_top:spec.pad_top + nh, spec.pad_left:spec.pad_left + nw] = r.flip(-1)
    return out.numpy()


@pytest.mark.parametrize("src_hw,dst_hw,stretch", [
    ((360, 640), (128, 128), False), ((288, 512), (128, 128), False),
    ((300, 500), (128, 128), False), ((75, 131), (128, 128), False),
    ((90, 160), (64, 64), True), ((1080, 1920), (224, 224), True),
])
def test_kernel_tables_agree_with_plain(src_hw, dst_hw, stretch):
    frames = _frames(src_hw, n=1, seed=2)
    spec = stretch_spec(src_hw, dst_hw) if stretch else letterbox_spec(src_hw, dst_hw)
    got = _emulate_kernel(frames, spec)
    want = letterbox_plain(torch.from_numpy(frames), spec, torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    if src_hw in ((360, 640), (288, 512)):  # select, mean2: exact taps
        ref = preprocess_batch(torch.from_numpy(frames), spec=spec, out_dtype=torch.float32,
                               layout="NHWC").numpy()
        np.testing.assert_array_equal(want, ref)
