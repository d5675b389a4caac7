"""B7, a float conv's epilogue in one pass (``ops/epilogue.py``, ``csrc/epilogue.cu``).

On the CPU:
(a) ``conv_epilogue_plain`` is bit for bit the composition it replaces on the
card: PyTorch's bias pass (``add_`` of the reshaped bias, in place), then
``F.silu``, then a bottleneck's ``x + y``; bf16 and fp32, act on and off,
no residual, a channels_last residual and a channel-slice view (C2f's
``chunk``), 80, 64 and 13 channels.
(b) the kernel runs only on the card, so its walk over the output is
replayed here: each thread's grid-stride loop, the (pixel, channel) it
carries from unit to unit without dividing, the masked last unit; every
element is reached once, with its own pixel and channel. The pickers
(``residual_stride``, ``epilogue_instantiation``) are held case by case.
(c) ``ConvAct`` on the CPU, and wherever a gradient is needed, keeps the
conv's own bias and the separate SiLU and add: the epilogue is never
called, the outputs and the gradients are those of the plain composition.
With the route opened to the CPU (``layers.fuses_epilogue`` replaced by
``cpu_route``, so the plain version stands in for the kernel), a YOLO
forward calls the epilogue once for each float conv, the bottlenecks'
shortcuts inside it.
(d) ``rva::conv_epilogue`` has its CPU and fake implementations, and an
exported YOLO step keeps it as one node a conv.
(e) The ReLU mode (``act="relu"``: bias, then the shortcut, then ReLU, as a
ResNet bottleneck ends): the plain version is PyTorch's passes bit for bit
on 4-d and 5-d (``channels_last_3d``) outputs, ``residual_stride`` reads
5-d residuals, ``rva::conv_epilogue_relu`` has its CPU and fake forms, and
a SlowFast R50 forward calls it once a conv, its 32 bottleneck shortcuts
inside.

On the card (``cuda`` marker; skipped elsewhere), run with
``python -m pytest --noconftest -m cuda tests/test_torch_conv_epilogue.py``:
the kernel bit-equal to PyTorch's passes at YOLOv8l's and YOLOv8n's b32
shapes and in each instantiation, and in the ReLU mode at SlowFast R50's b32
shapes (5-d) and in each instantiation, a misaligned output refused, the op equal
to the wrapper and safe under capture, captured YOLOv8l and YOLOv8n b32
steps with the epilogue against the same steps on PyTorch's passes (the
same outputs, one launch for each float conv), and a YOLOv8n step exported
on the card with one epilogue node a conv, served equal to the live
engine; SlowFast R50's stems as 2D convs over stacked frames against
cuDNN's conv3d route (``models/slowfast.py``), at the small and the
published spec.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from realtime_analytics_tpu_torch.models import layers
from realtime_analytics_tpu_torch.models.layers import ConvAct
from realtime_analytics_tpu_torch.models.yolo import Bottleneck, build_yolo
from realtime_analytics_tpu_torch.ops import _cuda
from realtime_analytics_tpu_torch.ops.epilogue import (
    DTYPES,
    conv_epilogue,
    conv_epilogue_plain,
    epilogue_instantiation,
    residual_stride,
)

_BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def two_pass(y, bias, act, residual=None):
    """What the card ran before the epilogue: cuDNN's output, PyTorch's
    bias pass in place, ``F.silu``, the bottleneck's ``x + y``."""
    y = y.clone()
    y.add_(bias.reshape(1, -1, 1, 1))
    if act:
        y = F.silu(y)
    return y if residual is None else residual + y


def bits(t):
    return t.contiguous().view(_BITS[t.dtype])


def make_case(c, dtype, residual, gen, shape=(2, 5, 7), device="cpu"):
    """A channels_last conv output, a bias and a residual (None, "full" or
    "slice": the second half of a channels_last tensor of 2c channels)."""
    n, h, w = shape

    def cl(ch, scale):
        t = torch.randn(n, ch, h, w, generator=gen, device=device) * scale
        return t.to(dtype).contiguous(memory_format=torch.channels_last)

    y = cl(c, 4.0)
    flat = y.permute(0, 2, 3, 1).reshape(-1)
    if flat.numel() >= 8:  # infinities, a NaN, -0 and a value whose exp overflows
        flat[:5] = torch.tensor([float("inf"), -float("inf"), float("nan"), -0.0, -95.0],
                                dtype=dtype, device=device)
    bias = (torch.randn(c, generator=gen, device=device) * 2).to(dtype)
    res = None
    if residual == "full":
        res = cl(c, 3.0)
    elif residual == "slice":
        res = cl(2 * c, 3.0).chunk(2, dim=1)[1]
    return y, bias, res


# -- (a) the plain version is the composition it replaces -----------------------


@pytest.mark.parametrize("c", [80, 64, 13])
@pytest.mark.parametrize("residual", [None, "full", "slice"])
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_plain_is_the_two_pass_composition(dtype, act, residual, c):
    gen = torch.Generator().manual_seed(c + 7 * (residual is not None) + 3 * act)
    act = "silu" if act else None
    y, bias, res = make_case(c, dtype, residual, gen)
    want = two_pass(y, bias, act, res)
    got = conv_epilogue_plain(y, bias, act, res)
    assert got.dtype == dtype and got.shape == y.shape
    assert torch.equal(bits(got), bits(want))
    # the wrapper on the CPU is the plain version, and leaves y as it was
    before = y.clone()
    assert torch.equal(bits(conv_epilogue(y, bias, act, res)), bits(want))
    assert torch.equal(bits(y), bits(before))


# -- (b) the kernel's walk, replayed --------------------------------------------


def walk(elems, c, vec, aligned, grid_threads):
    """csrc/epilogue.cu's loop, thread by thread: the (pixel, channel) each
    element is given. Returns {element: (pixel, channel)}."""
    seen = {}
    units = (elems + vec - 1) // vec
    step = grid_threads
    step_p, step_c = divmod(step * vec, c)
    for u0 in range(grid_threads):
        if u0 >= units:
            break
        p, ch = divmod(u0 * vec, c)
        for u in range(u0, units, step):
            e = u * vec
            if aligned:
                assert ch + vec <= c, "a unit crossed a pixel"
                for i in range(vec):
                    assert e + i not in seen
                    seen[e + i] = (p, ch + i)
            else:
                n = min(vec, elems - e)
                pp, cc = p, ch
                for i in range(vec):
                    if i < n:
                        assert e + i not in seen
                        seen[e + i] = (pp, cc)
                    cc += 1
                    if cc == c:
                        cc, pp = 0, pp + 1
            ch += step_c
            p += step_p
            if ch >= c:
                ch, p = ch - c, p + 1
    return seen


@pytest.mark.parametrize("pixels,c,vec,aligned", [
    (37, 64, 8, True), (37, 80, 8, True), (19, 64, 4, True),  # vec16, bf16 and fp32
    (37, 13, 8, False), (11, 3, 8, False), (29, 13, 4, False),  # flat16: any C
    (5, 1, 8, False), (17, 255, 8, False),
    (37, 16, 8, True), (23, 32, 8, True),  # vec16 at YOLOv8n's narrowest widths
])
@pytest.mark.parametrize("grid_threads", [1, 7, 64, 1000])
def test_kernel_walk_reaches_every_element_once(pixels, c, vec, aligned, grid_threads):
    elems = pixels * c
    seen = walk(elems, c, vec, aligned, grid_threads)
    assert sorted(seen) == list(range(elems))
    assert all(seen[e] == divmod(e, c) for e in seen)


def test_residual_stride():
    y = torch.zeros(2, 16, 3, 5).contiguous(memory_format=torch.channels_last)
    wide = torch.zeros(2, 32, 3, 5).contiguous(memory_format=torch.channels_last)
    a, b = wide.chunk(2, dim=1)
    assert residual_stride(y, y.clone()) == 16
    assert residual_stride(y, a) == 32 and residual_stride(y, b) == 32
    assert residual_stride(y, torch.zeros(2, 16, 3, 5)) is None  # NCHW
    assert residual_stride(y, wide) is None  # another shape
    assert residual_stride(y, y.double()) is None  # another dtype
    one = torch.zeros(4, 8, 1, 1).contiguous(memory_format=torch.channels_last)
    assert residual_stride(one, one.clone()) == 8


def test_instantiation():
    bf, f32 = torch.bfloat16, torch.float32
    assert epilogue_instantiation(bf, 64, True) == "vec16"
    assert epilogue_instantiation(bf, 80, True) == "vec16"
    assert epilogue_instantiation(f32, 64, True) == "vec16"
    assert epilogue_instantiation(f32, 13, True) == "flat16"
    assert epilogue_instantiation(bf, 13, True) == "flat16"
    assert epilogue_instantiation(bf, 12, True) == "flat16"  # 12 % 8
    assert epilogue_instantiation(f32, 12, True) == "vec16"
    assert epilogue_instantiation(bf, 64, True, 128) == "vec16"  # a C2f slice
    assert epilogue_instantiation(bf, 64, False, 128) == "flat16"
    assert epilogue_instantiation(bf, 64, True, 68) == "flat16"
    assert epilogue_instantiation(bf, 16, True, 32) == "vec16"  # YOLOv8n's first C2f
    assert epilogue_instantiation(torch.float16, 64, True) is None


# -- (c) who takes the epilogue -------------------------------------------------


def conv_case(gen, dtype=torch.float32, cin=8, cout=8, hw=6):
    conv = ConvAct(cin, cout, 3)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(cout, cin, 3, 3, generator=gen) * 0.3)
        conv.bias.copy_(torch.randn(cout, generator=gen))
    conv = conv.to(dtype=dtype, memory_format=torch.channels_last)
    x = torch.randn(2, cin, hw, hw, generator=gen).to(dtype).contiguous(
        memory_format=torch.channels_last)
    return conv, x


def refuse(*args, **kwargs):
    raise AssertionError("the epilogue was called")


def cpu_route(x, *operands):
    """``layers.fuses_epilogue`` with the CPU in place of the card: a float
    tensor, and no operand that needs a gradient."""
    return x.dtype in DTYPES and not (
        torch.is_grad_enabled()
        and any(t is not None and t.requires_grad for t in (x, *operands)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cpu_conv_act_keeps_the_plain_composition(monkeypatch, dtype):
    monkeypatch.setattr(layers, "conv_epilogue", refuse)
    conv, x = conv_case(torch.Generator().manual_seed(1), dtype)
    want = F.silu(F.conv2d(x, conv.weight, conv.bias, padding=1))
    assert torch.equal(bits(conv(x)), bits(want))
    res = torch.randn_like(x)
    assert torch.equal(bits(conv(x, residual=res)), bits(res + want))
    blk = Bottleneck(8, 8)
    blk.cv1, blk.cv2 = conv, conv
    assert torch.equal(bits(blk(x, True)), bits(x + conv(conv(x))))
    assert torch.equal(bits(blk(x, False)), bits(conv(conv(x))))


def test_a_gradient_keeps_the_plain_composition(monkeypatch):
    monkeypatch.setattr(layers, "fuses_epilogue", cpu_route)
    monkeypatch.setattr(layers, "conv_epilogue", refuse)
    gen = torch.Generator().manual_seed(2)
    conv, x = conv_case(gen)
    res = torch.randn(x.shape, generator=gen)
    conv.weight.requires_grad_(True)
    conv.bias.requires_grad_(True)
    x.requires_grad_(True)
    got = conv(x, residual=res)
    w, b = conv.weight.detach().requires_grad_(True), conv.bias.detach().requires_grad_(True)
    x2 = x.detach().requires_grad_(True)
    want = res + F.silu(F.conv2d(x2, w, b, padding=1))
    assert torch.equal(got, want)
    g = torch.randn(got.shape, generator=gen)
    got_grads = torch.autograd.grad(got, (x, conv.weight, conv.bias), g)
    want_grads = torch.autograd.grad(want, (x2, w, b), g)
    for a, e in zip(got_grads, want_grads):
        assert torch.equal(a, e)
    # a gradient on the residual alone is enough
    conv.weight.requires_grad_(False)
    conv.bias.requires_grad_(False)
    conv(x.detach(), residual=res.requires_grad_(True))


def test_no_gradient_takes_the_epilogue(monkeypatch):
    monkeypatch.setattr(layers, "fuses_epilogue", cpu_route)
    calls = []

    def spy(y, bias, act, residual=None):
        calls.append((tuple(y.shape), act, residual is not None))
        return conv_epilogue(y, bias, act, residual)

    monkeypatch.setattr(layers, "conv_epilogue", spy)
    gen = torch.Generator().manual_seed(3)
    conv, x = conv_case(gen, torch.bfloat16)
    res = torch.randn(x.shape, generator=gen).to(torch.bfloat16)
    got = conv(x, residual=res)
    assert calls == [((2, 8, 6, 6), "silu", True)]
    want = two_pass(F.conv2d(x, conv.weight, padding=1), conv.bias, True, res)
    assert torch.equal(bits(got), bits(want))
    conv.weight.requires_grad_(True)  # a gradient that is not enabled
    with torch.no_grad():
        conv(x)
    assert len(calls) == 2


def float_convs(model, stem: bool) -> int:
    """The float convs of a YOLO forward: every ``ConvAct`` but the two
    that B3 runs when the stem is fused."""
    return sum(isinstance(m, ConvAct) for m in model.modules()) - (2 if stem else 0)


@pytest.mark.parametrize("size,total", [("n", 63), ("l", 103)])
def test_yolo_forward_calls_the_epilogue_once_a_conv(monkeypatch, size, total):
    """YOLOv8l: 101 ``ConvAct`` outputs (95 with SiLU, the head's 6 last
    1x1s without) and the 2 split 1x1s of the fused neck (``up_concat``:
    their skip halves take the bias, SiLU off); 18 bottlenecks add their
    shortcut inside the epilogue. YOLOv8n: 61 and 2; 6 shortcuts."""
    monkeypatch.setattr(layers, "fuses_epilogue", cpu_route)
    calls = []

    def spy(y, bias, act, residual=None):
        calls.append((act, residual is not None))
        return conv_epilogue(y, bias, act, residual)

    monkeypatch.setattr(layers, "conv_epilogue", spy)
    model = build_yolo("yolov8", size, 80).to(memory_format=torch.channels_last).eval()
    model.pallas_stem = "off"
    assert float_convs(model, stem=False) == total
    with torch.no_grad():
        model(torch.zeros(1, 64, 64, 3), reduce_scores=True)
    assert len(calls) == total
    assert sum(not act for act, _ in calls) == 6 + 2
    assert sum(r for _, r in calls) == (18 if size == "l" else 6)


# -- (d) the registered op ------------------------------------------------------


def test_op_cpu_and_fake():
    gen = torch.Generator().manual_seed(4)
    y, bias, res = make_case(64, torch.bfloat16, "slice", gen)
    got = torch.ops.rva.conv_epilogue(y, bias, res, True)
    assert torch.equal(bits(got), bits(two_pass(y, bias, True, res)))
    assert torch.equal(bits(torch.ops.rva.conv_epilogue(y, bias, None, False)),
                       bits(two_pass(y, bias, False)))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fy = mode.from_tensor(y)
        out = torch.ops.rva.conv_epilogue(fy, mode.from_tensor(bias), None, True)
        assert out.shape == y.shape and out.dtype == y.dtype
        assert out.is_contiguous(memory_format=torch.channels_last)


def test_exported_step_keeps_the_epilogue_as_one_node_a_conv(monkeypatch, tmp_path):
    import io
    import zipfile

    from realtime_analytics_tpu_torch.config import DetectorConfig
    from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine
    from realtime_analytics_tpu_torch.engine.export import (
        ExportedYoloEngine,
        export_serving_artifact,
    )
    from realtime_analytics_tpu_torch.models.weights import synthetic_params

    monkeypatch.setattr(layers, "fuses_epilogue", cpu_route)
    params = synthetic_params(build_yolo("yolov8", "n", 80), seed=0)

    def cfg(path):
        return DetectorConfig(model_path=path, model_type="yolov8", device="cpu",
                              input_size=[64, 64], batch_buckets=[2], max_batch_size=2,
                              confidence_threshold=0.01, warmup=False, precision="fp32")

    live = TorchYoloEngine(cfg("seeded-yolov8n"), params=params)
    path = str(tmp_path / "epilogue.rvae")
    meta = export_serving_artifact(live, path, src_hws=[(192, 192)])
    stem = live.model.stem_ok(64, 64)
    with zipfile.ZipFile(path) as zf:
        for p in meta["programs"]:
            ep = torch.export.load(io.BytesIO(zf.read(f"programs/{p['name']}.pt2")))
            targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
            assert targets.count("rva.conv_epilogue.default") == float_convs(live.model, stem)
            assert targets.count("rva.fused_stem_p1p2.default") == int(stem)
    served = ExportedYoloEngine(cfg(path))
    frames = np.random.default_rng(0).integers(0, 255, (2, 192, 192, 3), np.uint8)
    live.predict_arrays(frames.copy())
    served.predict_arrays(frames.copy())
    a, b = live.predict_arrays(frames.copy()), served.predict_arrays(frames.copy())
    assert int(a.num_valid.sum()) > 0
    for f in ("boxes_xyxy", "scores", "class_ids", "num_valid"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# -- (e) the ReLU mode ----------------------------------------------------------


def two_pass_relu(y, bias, residual=None):
    """A ResNet conv on PyTorch's passes: the bias pass in place, the
    bottleneck's ``y + shortcut``, ``F.relu``."""
    y = y.clone()
    y.add_(bias.reshape(1, -1, *([1] * (y.dim() - 2))))
    if residual is not None:
        y = y + residual
    return F.relu(y)


def make_case_nd(c, dtype, residual, gen, shape, device="cpu"):
    """``make_case`` for a 4-d (channels_last) or 5-d (channels_last_3d)
    output: ``shape`` is (n, h, w) or (n, d, h, w)."""
    fmt = torch.channels_last_3d if len(shape) == 4 else torch.channels_last

    def cl(ch, scale):
        t = torch.randn(shape[0], ch, *shape[1:], generator=gen, device=device) * scale
        return t.to(dtype).contiguous(memory_format=fmt)

    y = cl(c, 4.0)
    flat = y.movedim(1, -1).reshape(-1)
    if flat.numel() >= 8:
        flat[:5] = torch.tensor([float("inf"), -float("inf"), float("nan"), -0.0, -95.0],
                                dtype=dtype, device=device)
    bias = (torch.randn(c, generator=gen, device=device) * 2).to(dtype)
    bias[:1] = 0.0  # a -0 + 0 stays in the ReLU's path
    res = None
    if residual == "full":
        res = cl(c, 3.0)
    elif residual == "slice":
        res = cl(2 * c, 3.0).chunk(2, dim=1)[1]
    return y, bias, res


@pytest.mark.parametrize("shape", [(2, 5, 7), (2, 3, 5, 7)], ids=["4d", "5d"])
@pytest.mark.parametrize("c", [80, 64, 13])
@pytest.mark.parametrize("residual", [None, "full", "slice"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_plain_relu_is_the_two_pass_composition(dtype, residual, c, shape):
    gen = torch.Generator().manual_seed(c + 5 * len(shape) + 7 * (residual is not None))
    y, bias, res = make_case_nd(c, dtype, residual, gen, shape)
    want = two_pass_relu(y, bias, res)
    got = conv_epilogue_plain(y, bias, "relu", res)
    assert got.dtype == dtype and got.shape == y.shape
    assert torch.equal(bits(got), bits(want))
    before = y.clone()
    assert torch.equal(bits(conv_epilogue(y, bias, "relu", res)), bits(want))
    assert torch.equal(bits(y), bits(before))
    # the YOLO modes on a 5-d output: bias, SiLU, the add after it
    for act in ("silu", None):
        plain = conv_epilogue_plain(y, bias, act, res)
        two = y.clone()
        two.add_(bias.reshape(1, -1, *([1] * (y.dim() - 2))))
        two = F.silu(two) if act else two
        assert torch.equal(bits(plain), bits(two if res is None else res + two))


def test_residual_stride_5d():
    fmt = torch.channels_last_3d
    y = torch.zeros(2, 16, 4, 3, 5).contiguous(memory_format=fmt)
    wide = torch.zeros(2, 32, 4, 3, 5).contiguous(memory_format=fmt)
    a, b = wide.chunk(2, dim=1)
    assert residual_stride(y, y.clone()) == 16
    assert residual_stride(y, a) == 32 and residual_stride(y, b) == 32
    assert residual_stride(y, torch.zeros(2, 16, 4, 3, 5)) is None  # NCDHW
    assert residual_stride(y, wide) is None
    one = torch.zeros(4, 8, 1, 1, 1).contiguous(memory_format=fmt)
    assert residual_stride(one, one.clone()) == 8


def test_act_names():
    y, bias, _ = make_case_nd(8, torch.float32, None, torch.Generator().manual_seed(1), (1, 2, 2))
    for act in ("gelu", True, False):  # one spelling: None, "silu" or "relu"
        with pytest.raises(ValueError, match="act must be"):
            conv_epilogue(y, bias, act)


def test_relu_op_cpu_and_fake():
    gen = torch.Generator().manual_seed(9)
    y, bias, res = make_case_nd(64, torch.bfloat16, "slice", gen, (2, 3, 5, 7))
    got = torch.ops.rva.conv_epilogue_relu(y, bias, res)
    assert torch.equal(bits(got), bits(two_pass_relu(y, bias, res)))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        out = torch.ops.rva.conv_epilogue_relu(mode.from_tensor(y), mode.from_tensor(bias), None)
        assert out.shape == y.shape and out.dtype == y.dtype
        assert out.is_contiguous(memory_format=torch.channels_last_3d)
    # through the registered ops (an exported step): the relu op
    with _cuda.through_ops():
        assert torch.equal(bits(conv_epilogue(y, bias, "relu", res)), bits(got))


def test_slowfast_forward_calls_the_relu_epilogue_once_a_conv(monkeypatch):
    """SlowFast R50 at the published depths (slow width 16): 110 convs, each
    with its BN folded, one epilogue each: 2 stems and 4 laterals and 64
    bottleneck convs before the last with ReLU, 32 bottleneck ends adding
    their shortcut before it, 8 projections without."""
    from realtime_analytics_tpu_torch.models import slowfast

    monkeypatch.setattr(slowfast, "fuses_epilogue", cpu_route)
    calls = []

    def spy(y, bias, act, residual=None):
        calls.append((act, residual is not None, y.dim()))
        return conv_epilogue(y, bias, act, residual)

    monkeypatch.setattr(slowfast, "conv_epilogue", spy)
    model = slowfast.SlowFastR50(slowfast.SlowFastSpec(width=16)).eval()
    with torch.no_grad():
        model(torch.zeros(1, 8, 32, 32, 3))
    assert len(calls) == 110 and all(d == 5 for *_, d in calls)
    assert sum(a == "relu" and r for a, r, _ in calls) == 32
    assert sum(a == "relu" and not r for a, r, _ in calls) == 70
    assert sum(a is None for a, r, _ in calls) == 8


# -- on the card ----------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100 machine)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    torch.backends.cudnn.allow_tf32 = False
    _cuda.lib()
    return torch.device("cuda", 0)


# YOLOv8l at b32, 640: the node 0 output (the largest), a backbone C2f's
# bottleneck with its chunk as the residual, SPPF's width, the head's box and
# class 1x1s (no SiLU); YOLOv8n at b32: its first C2f's bottleneck (16
# channels, the chunk of 32 as the residual) and its 32-channel convs; then
# fp32 and 13 channels (flat16)
CARD_CASES = [
    ((32, 320, 320), 64, torch.bfloat16, True, None, "vec16"),
    ((32, 160, 160), 64, torch.bfloat16, True, "slice", "vec16"),
    ((32, 80, 80), 128, torch.bfloat16, True, "full", "vec16"),
    ((32, 20, 20), 512, torch.bfloat16, True, None, "vec16"),
    ((32, 80, 80), 64, torch.bfloat16, False, None, "vec16"),
    ((32, 80, 80), 80, torch.bfloat16, False, None, "vec16"),
    ((32, 160, 160), 16, torch.bfloat16, True, "slice", "vec16"),
    ((32, 160, 160), 16, torch.bfloat16, True, None, "vec16"),
    ((32, 160, 160), 32, torch.bfloat16, True, None, "vec16"),
    ((32, 80, 80), 32, torch.bfloat16, True, "full", "vec16"),
    ((4, 40, 40), 64, torch.float32, True, "slice", "vec16"),
    ((3, 17, 9), 13, torch.bfloat16, True, "slice", "flat16"),
    ((3, 17, 9), 13, torch.float32, False, "full", "flat16"),
    ((2, 5, 7), 3, torch.bfloat16, True, None, "flat16"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c,dtype,act,residual,inst", CARD_CASES)
def test_kernel_bit_equal_to_the_two_passes(card, shape, c, dtype, act, residual, inst):
    gen = torch.Generator(device=card).manual_seed(c + shape[1])
    y, bias, res = make_case(c, dtype, residual, gen, shape, card)
    s = None if res is None else residual_stride(y, res)
    assert epilogue_instantiation(dtype, c, True, s) == inst
    want = two_pass(y, bias, act, res)
    before = _cuda.LAUNCHES.snapshot()["conv_epilogue"]
    got = conv_epilogue(y, bias, "silu" if act else None, res)
    torch.cuda.synchronize()
    assert got.data_ptr() == y.data_ptr()  # in place
    assert _cuda.LAUNCHES.snapshot()["conv_epilogue"] == before + 1
    assert torch.equal(bits(got), bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_kernel_refuses_a_misaligned_output(card, dtype):
    wide = torch.zeros(3 * 6 * 5 * 16 + 1, device=card, dtype=dtype)
    y = wide[1:].view(3, 6, 5, 16).permute(0, 3, 1, 2)  # channels_last, 2 or 4 bytes off
    before = _cuda.LAUNCHES.snapshot()["conv_epilogue"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        conv_epilogue(y, torch.zeros(16, device=card, dtype=dtype), "silu")
    assert _cuda.LAUNCHES.snapshot()["conv_epilogue"] == before


@pytest.mark.cuda
def test_kernel_takes_another_layout_through_a_copy(card):
    gen = torch.Generator(device=card).manual_seed(7)
    y = (torch.randn(2, 64, 9, 11, generator=gen, device=card) * 3).to(torch.bfloat16)
    bias = torch.randn(64, generator=gen, device=card).to(torch.bfloat16)
    want = two_pass(y, bias, True)
    got = conv_epilogue(y, bias, "silu")  # NCHW: copied to channels_last, then in place
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(bits(got), bits(want))


@pytest.mark.cuda
def test_op_equals_the_wrapper_and_captures(card):
    gen = torch.Generator(device=card).manual_seed(6)
    y, bias, res = make_case(64, torch.bfloat16, "slice", gen, (8, 40, 40), card)
    want = two_pass(y, bias, True, res)
    before = _cuda.LAUNCHES.snapshot()["conv_epilogue"]
    out = torch.ops.rva.conv_epilogue(y, bias, res, True)
    assert _cuda.LAUNCHES.snapshot()["conv_epilogue"] == before + 1
    assert out.data_ptr() != y.data_ptr()
    assert torch.equal(bits(out), bits(want))
    # inside a CUDA graph: the same launch, replayed
    buf = y.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        conv_epilogue(buf.copy_(y), bias, "silu", res)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        conv_epilogue(buf.copy_(y), bias, "silu", res)
    buf.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(bits(buf), bits(want))


def captured_step_against_two_passes(monkeypatch, size, total):
    """YOLOv8 ``size``, bf16, bucket 32 at 640 (a benchmark cell's step,
    captured at warmup; B3 on where it applies): the epilogue's outputs
    against the same step with every conv on PyTorch's passes, and one
    epilogue launch a float conv."""
    from realtime_analytics_tpu_torch.config import DetectorConfig
    from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine
    from realtime_analytics_tpu_torch.models.weights import synthetic_params

    params = synthetic_params(build_yolo("yolov8", size, 80), seed=0)
    cfg = DetectorConfig(model_path=f"seeded-yolov8{size}", device="cuda",
                         input_size=[640, 640], max_batch_size=32, batch_buckets=[32],
                         precision="bf16", confidence_threshold=0.005, warmup=False)
    frames = np.random.default_rng(0).integers(0, 255, (32, 1080, 1920, 3), np.uint8)

    def run(eng):
        eng.predict_arrays(frames)
        torch.cuda.synchronize()
        _cuda.LAUNCHES.reset()
        res = eng.predict_arrays(frames)
        return res, _cuda.LAUNCHES.snapshot()

    with torch.inference_mode():
        eng = TorchYoloEngine(cfg, params=params)
        got, launches = run(eng)
        stem = launches["fused_stem"] > 0
        assert launches["conv_epilogue"] == float_convs(eng.model, stem) == total
        del eng
        with monkeypatch.context() as m:
            m.setattr(layers, "fuses_epilogue", lambda *a: False)  # PyTorch's passes
            ref, ref_launches = run(TorchYoloEngine(cfg, params=params))
    assert ref_launches["conv_epilogue"] == 0
    assert ref_launches["fused_stem"] == launches["fused_stem"]
    assert int(got.num_valid.sum()) > 0
    for f in ("boxes_xyxy", "scores", "class_ids", "num_valid"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))


@pytest.mark.cuda
def test_captured_yolov8l_step_equals_the_two_pass_step(card, monkeypatch):
    """The footage cell's step: 103 float convs (B3 does not fit v8l)."""
    captured_step_against_two_passes(monkeypatch, "l", 103)


@pytest.mark.cuda
def test_captured_yolov8n_step_equals_the_two_pass_step(card, monkeypatch):
    """The cameras cell's and the main path's step: 61 float convs (B3
    runs nodes 0-1), down to 16 channels."""
    captured_step_against_two_passes(monkeypatch, "n", 61)


@pytest.mark.cuda
def test_card_export_keeps_the_epilogue_a_conv(card, tmp_path):
    """On the card a traced conv's output reads NCHW-contiguous (the fake
    tensor's layout), so the route must not hang on the layout: each float
    conv of the exported step is one ``rva.conv_epilogue`` node, and the
    served step launches it as the live one does."""
    import io
    import zipfile

    from realtime_analytics_tpu_torch.config import DetectorConfig
    from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine
    from realtime_analytics_tpu_torch.engine.export import (
        ExportedYoloEngine,
        export_serving_artifact,
    )
    from realtime_analytics_tpu_torch.models.weights import synthetic_params

    params = synthetic_params(build_yolo("yolov8", "n", 80), seed=0)

    def cfg(path):
        return DetectorConfig(model_path=path, device="cuda", input_size=[640, 640],
                              max_batch_size=8, batch_buckets=[8], precision="bf16",
                              confidence_threshold=0.005, warmup=False)

    live = TorchYoloEngine(cfg("seeded-yolov8n"), params=params)
    path = str(tmp_path / "card.rvae")
    meta = export_serving_artifact(live, path, src_hws=[(1080, 1920)])
    with zipfile.ZipFile(path) as zf:
        for p in meta["programs"]:
            ep = torch.export.load(io.BytesIO(zf.read(p["file"])))
            targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
            assert targets.count("rva.conv_epilogue.default") == float_convs(live.model, True)
    served = ExportedYoloEngine(cfg(path))
    frames = np.random.default_rng(1).integers(0, 255, (8, 1080, 1920, 3), np.uint8)
    with torch.inference_mode():
        live.predict_arrays(frames)
        served.predict_arrays(frames)
        a = live.predict_arrays(frames)
        _cuda.LAUNCHES.reset()
        b = served.predict_arrays(frames)
        assert _cuda.LAUNCHES.snapshot()["conv_epilogue"] == 61
    for f in ("boxes_xyxy", "scores", "class_ids", "num_valid"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# SlowFast R50 8x8 at b32, 224 (sf50-clips-b32's step), ReLU mode: the slow
# and fast stems (before their pools), a slow res2 and a fast res2
# bottleneck end with their shortcut, a res4 a-conv, a lateral, res5's end;
# then a projection (no activation) on 5-d, fp32, 13 channels (flat16) and
# a chunk residual
SLOWFAST_CARD_CASES = [
    ((32, 8, 112, 112), 64, torch.bfloat16, "relu", None, "vec16"),
    ((32, 32, 112, 112), 8, torch.bfloat16, "relu", None, "vec16"),
    ((32, 8, 56, 56), 256, torch.bfloat16, "relu", "full", "vec16"),
    ((32, 32, 56, 56), 32, torch.bfloat16, "relu", "full", "vec16"),
    ((32, 8, 14, 14), 256, torch.bfloat16, "relu", None, "vec16"),
    ((32, 8, 56, 56), 16, torch.bfloat16, "relu", None, "vec16"),
    ((32, 8, 7, 7), 2048, torch.bfloat16, "relu", "full", "vec16"),
    ((32, 8, 28, 28), 512, torch.bfloat16, None, None, "vec16"),
    ((4, 8, 14, 14), 64, torch.float32, "relu", "full", "vec16"),
    ((3, 5, 17, 9), 13, torch.bfloat16, "relu", "slice", "flat16"),
    ((3, 5, 17, 9), 13, torch.float32, "relu", "full", "flat16"),
    ((2, 4, 9, 11), 64, torch.bfloat16, "relu", "slice", "vec16"),
    ((2, 9, 11), 64, torch.bfloat16, "relu", "full", "vec16"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,c,dtype,act,residual,inst", SLOWFAST_CARD_CASES)
def test_relu_kernel_bit_equal_to_the_passes(card, shape, c, dtype, act, residual, inst):
    gen = torch.Generator(device=card).manual_seed(c + shape[-1])
    y, bias, res = make_case_nd(c, dtype, residual, gen, shape, card)
    s = None if res is None else residual_stride(y, res)
    assert epilogue_instantiation(dtype, c, True, s) == inst
    if act == "relu":
        want = two_pass_relu(y, bias, res)
    else:
        want = y.clone()
        want.add_(bias.reshape(1, -1, 1, 1, 1))
    before = _cuda.LAUNCHES.snapshot()["conv_epilogue"]
    got = conv_epilogue(y, bias, act, res)
    torch.cuda.synchronize()
    assert got.data_ptr() == y.data_ptr()
    assert _cuda.LAUNCHES.snapshot()["conv_epilogue"] == before + 1
    assert torch.equal(bits(got), bits(want))


@pytest.mark.cuda
def test_relu_op_equals_the_wrapper_on_the_card(card):
    gen = torch.Generator(device=card).manual_seed(8)
    y, bias, res = make_case_nd(64, torch.bfloat16, "full", gen, (4, 8, 14, 14), card)
    want = two_pass_relu(y, bias, res)
    out = torch.ops.rva.conv_epilogue_relu(y, bias, res)
    assert out.data_ptr() != y.data_ptr()
    assert torch.equal(bits(out), bits(want))


@pytest.mark.cuda
def test_slowfast_forward_equals_the_passes(card, monkeypatch):
    """The published SlowFast R50 in bf16 on 4 clips of 32 x 224 x 224 with
    seeded weights: one epilogue launch a conv (110), and the logits of the
    forward on PyTorch's passes bit for bit."""
    from realtime_analytics_tpu_torch.models import slowfast, weights

    model = slowfast.SlowFastR50().eval()
    sd = weights.slowfast_seeded_state_dict(model.spec, seed=3, device=card)
    weights.temporal_params_from_jax(model, weights.slowfast_params_from_state_dict(model, sd))
    model = model.to(card, torch.bfloat16)
    gen = torch.Generator(device=card).manual_seed(4)
    x = torch.randn(4, 32, 224, 224, 3, generator=gen, device=card).to(torch.bfloat16)
    with torch.inference_mode():
        _cuda.LAUNCHES.reset()
        got = model(x)
        assert _cuda.LAUNCHES.snapshot()["conv_epilogue"] == 110
        monkeypatch.setattr(slowfast, "fuses_epilogue", lambda *a: False)
        want = model(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# the logits of the stems' two routes, as the benchmark's logit_err (%): both
# are bf16 forwards that differ in the stems' fp32 summation order, so they
# sit closer to each other than either does to fp32 (sound runs read up to
# 1.79% against the plain fp32 reference)
STACKED_LOGIT_TOL = 1.8


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["small", "published"])
def test_slowfast_stacked_stems_equal_the_3d_route(card, monkeypatch, spec):
    """SlowFast R50 in bf16 at b2 (the small spec at 64 x 64; the published
    one at 224 x 224): every conv whose input channels are not a multiple of
    8 runs as a 2D conv over stacked frames, and the count says so; at the
    published widths that is the two stems and no other conv (the slow stem
    in rows of 1 frame, the fast stem of 4), while the small spec's fast
    pathway (2 channels at its stem) takes more. Each stem's output is
    within two bf16 roundings of cuDNN's conv3d route, the logits within
    ``STACKED_LOGIT_TOL``; the weights keep their published shape."""
    from realtime_analytics_tpu_torch.models import slowfast, weights

    small = slowfast.SlowFastSpec(depths=(1, 1, 1, 1), width=16)
    sf_spec, hw = (small, 64) if spec == "small" else (slowfast.SlowFastSpec(), 224)
    model = slowfast.SlowFastR50(sf_spec).eval()
    sd = weights.slowfast_seeded_state_dict(sf_spec, seed=5, device=card)
    weights.temporal_params_from_jax(model, weights.slowfast_params_from_state_dict(model, sd))
    model = model.to(card, torch.bfloat16)
    stems = [model.s1.pathway0_stem.conv, model.s1.pathway1_stem.conv]
    shapes = [tuple(c.weight.shape) for c in stems]
    outs, groups = {}, {}

    def keep(mod, args, out):
        outs.setdefault(mod, []).append(out.float())
        groups.setdefault(mod, []).append(mod.stack_group(args[0]))

    for mod in model.modules():
        if isinstance(mod, slowfast.FoldedConv3d):
            mod.register_forward_hook(keep)
    gen = torch.Generator(device=card).manual_seed(6)
    x = torch.randn(2, 32, hw, hw, 3, generator=gen, device=card).to(torch.bfloat16)
    with torch.inference_mode():
        got = model(x).float()
        stacked = {m: g[0] for m, g in groups.items() if g[0]}
        assert slowfast.stacked_convs(model) == len(stacked)
        assert all(stem in stacked for stem in stems)
        if spec == "published":
            assert list(stacked.values()) == [1, 4] and list(stacked) == stems
        monkeypatch.setattr(slowfast.FoldedConv3d, "stack_group", lambda self, t: 0)
        want = model(x).float()
    assert slowfast.stacked_convs(model) == len(stacked)
    assert [tuple(c.weight.shape) for c in stems] == shapes and all(s[1] == 3 for s in shapes)
    for stem in stems:
        stacked_out, plain = outs[stem]
        torch.testing.assert_close(stacked_out, plain, rtol=2 ** -6,
                                   atol=2 ** -7 * plain.abs().max().item())
    err = ((got - want).abs().amax(1) / want.std(1)).max().item() * 100
    assert err < STACKED_LOGIT_TOL, f"logit_err {err:.3f}%"
