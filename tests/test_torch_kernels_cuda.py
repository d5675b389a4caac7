"""Each hand-written CUDA kernel against its plain PyTorch version, on the card.

These need an NVIDIA Hopper card and nvcc; they carry the ``cuda`` marker
and skip elsewhere. Run them on a machine with the card:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Whether a card is present is decided inside the ``card`` fixture, never at
import time, so every pytest-xdist worker collects the same tests.
Tolerances: B1 bit-exact; B2 boxes atol 1e-3 px, conf atol 1e-5, classes
exact; B3 fp32 atol 1e-4, bf16 within 1% of the output range (P1 is rounded
to bf16 in both versions; accumulation order may flip one rounding).
"""

import numpy as np
import pytest
import torch

from realtime_analytics_tpu_torch.ops import _cuda
from realtime_analytics_tpu_torch.ops.decode import decode_v8_level, decode_v8_level_plain
from realtime_analytics_tpu_torch.ops.gather import row_gather, row_gather_plain
from realtime_analytics_tpu_torch.ops.stem import (
    fused_stem_p1p2,
    fused_stem_p1p2_plain,
    prepare_stem,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100 machine)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    torch.backends.cudnn.allow_tf32 = False
    _cuda.lib()  # build once for the module
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,m,p,k", [(32, 8400, 4, 512), (32, 512, 6, 300), (3, 100, 6, 7)])
def test_row_gather_bit_exact(card, n, m, p, k):
    g = torch.Generator(device=card).manual_seed(n + m + p + k)
    payload = torch.randn(n, m, p, generator=g, device=card) * 640
    bits = payload.view(torch.int32).view(-1)
    # a NaN with a payload, -0.0, +inf, the smallest denormal
    bits[:4] = torch.tensor([0x7FC01234, -(2**31), 0x7F800000, 1], device=card,
                            dtype=torch.int32)
    idx = torch.randint(0, m, (n, k), generator=g, device=card)
    idx[:, 0], idx[:, -1] = 0, m - 1
    before = _cuda.LAUNCHES.snapshot()["row_gather"]
    got = row_gather(payload, idx)
    assert _cuda.LAUNCHES.snapshot()["row_gather"] == before + 1
    want = row_gather_plain(payload, idx)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_row_gather_rejects_what_it_does_not_take(card):
    payload = torch.zeros(2, 10, 4, device=card)
    with pytest.raises(TypeError):
        row_gather(payload, torch.zeros(2, 3, dtype=torch.int32, device=card))
    with pytest.raises(ValueError):
        row_gather(payload[:, ::2], torch.zeros(2, 3, dtype=torch.int64, device=card))


@pytest.mark.parametrize("h,w,nc,dtype", [
    (80, 80, 80, torch.bfloat16), (40, 40, 80, torch.float32), (5, 7, 17, torch.bfloat16),
])
def test_decode_matches_plain(card, h, w, nc, dtype):
    g = torch.Generator(device=card).manual_seed(h * w + nc)
    box = (torch.randn(4, h, w, 64, generator=g, device=card) * 3).to(dtype)
    cls = (torch.randn(4, h, w, nc, generator=g, device=card) * 3).to(dtype)
    cls[:, 0] = 0  # every class tied: the first wins
    got = decode_v8_level(box, cls, stride=8.0)
    want = decode_v8_level_plain(box, cls, stride=8.0)
    torch.testing.assert_close(got[0], want[0], atol=1e-3, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0)
    assert torch.equal(got[2], want[2])
    assert bool((got[2][:, :w] == 0).all())


def test_decode_requires_nhwc_contiguous(card):
    box = torch.zeros(1, 64, 4, 4, device=card).permute(0, 2, 3, 1)  # NCHW-contig
    cls = torch.zeros(1, 4, 4, 80, device=card)
    with pytest.raises(ValueError):
        decode_v8_level(box, cls, stride=8.0)


@pytest.mark.parametrize("dtype,n,h,w,c0,c1", [
    (torch.bfloat16, 4, 640, 640, 16, 32),
    (torch.float32, 2, 128, 96, 16, 32),
    (torch.float32, 2, 68, 36, 32, 64),  # ragged tiles (H/4, W/4 not multiples of 8)
])
def test_stem_matches_plain(card, dtype, n, h, w, c0, c1):
    g = torch.Generator(device=card).manual_seed(h + w + c0)
    sw = prepare_stem(
        torch.randn(c0, 3, 3, 3, generator=g, device=card) * 0.3 / 255,
        torch.randn(c0, generator=g, device=card) * 0.1,
        torch.randn(c1, c0, 3, 3, generator=g, device=card) * (2 / (9 * c0)) ** 0.5,
        torch.randn(c1, generator=g, device=card) * 0.1,
        dtype,
    )
    x = torch.randint(0, 256, (n, h, w, 3), generator=g, device=card).to(dtype)
    got = fused_stem_p1p2(x, sw).float()
    want = fused_stem_p1p2_plain(x, sw).float()
    assert got.shape == (n, h // 4, w // 4, c1)
    err = (got - want).abs().max().item()
    tol = 1e-2 * want.abs().max().item() if dtype == torch.bfloat16 else 1e-4
    assert err <= tol, err
    assert np.isfinite(got.cpu().numpy()).all()
