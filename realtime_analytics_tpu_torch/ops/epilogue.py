"""B7: a float conv's elementwise epilogue (bias, SiLU or ReLU, shortcut add) in one pass.

No Pallas kernel stands behind this one: on the TPU, XLA fuses the JAX
package's conv bias and ``x * sigmoid(x)`` into the conv's own fusion. On
the card PyTorch runs a conv's bias as a pass of its own after cuDNN, then
``F.silu`` and a bottleneck's ``x + y`` as two more, so the conv's output
crosses device memory three or four times. ``conv_epilogue`` takes the
output of a conv run without its bias and does the three in one read and
one write (``csrc/epilogue.cu``), in place. ``act`` names the activation
and with it the order::

    "silu":  y = round(y + bias);  y = round(silu(y));  y = round(residual + y)
    None:    the same without the SiLU
    "relu":  y = round(y + bias);  y = round(residual + y);  y = relu(y)

each rounded to ``y``'s dtype, as the PyTorch passes round: the result is
theirs bit for bit. ``"silu"`` is YOLO's Conv with its bottleneck's
shortcut added after it; ``"relu"`` is a ResNet conv and, with a residual,
its bottleneck's ``relu(branch + shortcut)``. ``conv_epilogue_plain`` is
that composition in plain PyTorch (a new tensor); the wrapper takes it
only for tensors on the CPU.

``y`` is a conv's output, NCHW-logical in ``channels_last`` memory
([N, H, W, C] contiguous), or a 3D conv's NCDHW-logical output in
``channels_last_3d`` ([N, D, H, W, C] contiguous), bf16 or fp32; another
layout is copied to channels_last(_3d) first. (Under ``torch.export`` on
the card a traced conv's output reads NCHW-contiguous, so the layout
cannot decide whether a conv takes the epilogue.) ``residual`` has ``y``'s
shape and may be a channel-slice view of a wider channels_last tensor
(C2f's ``chunk``): the kernel reads it through its pixel stride
(``residual_stride``), so it is not copied; another layout is copied to
channels_last(_3d) first.

The kernel has two instantiations; ``epilogue_instantiation`` says which
a call takes: ``vec16`` (16-byte units within a pixel: C a multiple of 8 in
bf16 or 4 in fp32, a 16-byte aligned residual whose pixel stride is a
multiple of the unit) and ``flat16`` (16-byte units over the flat output,
any C: the last unit masked, the residual read element by element). Both
need ``y`` (and the op's output) 16-byte aligned, as every conv output and
fresh copy is; a misaligned one is refused.

The registered ops ``rva::conv_epilogue`` (act a bool: SiLU or none; the
form that exported artifacts hold, the one place ``act`` is a bool) and ``rva::conv_epilogue_relu`` are the
functional forms, which an exported step keeps as one node: on a CUDA
tensor the same launch into a new output, on a CPU one the plain version.
``conv_epilogue`` calls them inside ``_cuda.through_ops`` (an exported
step).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda

DTYPES = (torch.bfloat16, torch.float32)
MAX_CHANNELS = 12288  # the bias in 48 KB of shared memory (csrc/epilogue.cu)
_MODES = {"vec16": 1, "flat16": 0}
_ACTS = {None: 0, "silu": 1, "relu": 2}  # the C entry's act

Act = Optional[str]

_launch = None  # the bound C entry, set at the first launch


def act_code(act: Act) -> int:
    """The C entry's ``act``: 0 none, 1 SiLU, 2 ReLU (see the docstring)."""
    if not (act is None or isinstance(act, str)) or act not in _ACTS:
        raise ValueError(f"conv_epilogue: act must be None, 'silu' or 'relu', got {act!r}")
    return _ACTS[act]


def conv_epilogue_plain(y: torch.Tensor, bias: torch.Tensor, act: Act,
                        residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version, any device: ``y + bias`` (per channel), then
    ``F.silu`` and ``residual + y``, or ``residual + y`` and ``F.relu``; a
    new tensor."""
    code = act_code(act)
    y = y + bias.to(y.dtype).reshape(-1, *([1] * (y.dim() - 2)))
    if code == 2:
        return F.relu(y if residual is None else residual + y)
    if code == 1:
        y = F.silu(y)
    return y if residual is None else residual + y


def _memory_format(y: torch.Tensor) -> torch.memory_format:
    return torch.channels_last_3d if y.dim() == 5 else torch.channels_last


def residual_stride(y: torch.Tensor, residual: torch.Tensor) -> Optional[int]:
    """The elements from one pixel of ``residual`` to the next when its
    element (n, c, h, w) lies at ``((n * H + h) * W + w) * stride + c``
    (channels_last, or a channel slice of a channels_last tensor; a 5-d
    ``y`` likewise over (d, h, w) in channels_last_3d); None for another
    layout or shape."""
    if residual.shape != y.shape or residual.dtype != y.dtype:
        return None
    c, spatial = y.shape[1], y.shape[2:]
    # the innermost spatial axis longer than 1 (else the batch) gives the stride
    axes = [2 + i for i, size in enumerate(spatial) if size > 1]
    s = residual.stride(axes[-1] if axes else 0)
    if s < c:
        return None
    want, step = [0] * y.dim(), s
    for axis in range(y.dim() - 1, 1, -1):
        want[axis], step = step, step * y.shape[axis]
    want[0], want[1] = step, 1
    ok = all(size == 1 or got == exp
             for size, got, exp in zip(residual.shape, residual.stride(), want))
    return s if ok else None


def epilogue_instantiation(dtype: torch.dtype, c: int, res_aligned: bool = True,
                           res_stride: Optional[int] = None) -> Optional[str]:
    """Which instantiation a call takes: ``vec16``, ``flat16``, or None
    for a dtype the kernel does not take. ``res_aligned``, ``res_stride``:
    the residual's pointer is a multiple of 16 bytes, its pixel stride
    (None: no residual)."""
    if dtype not in DTYPES:
        return None
    unit = 8 if dtype == torch.bfloat16 else 4  # values in 16 bytes
    if c % unit == 0 and (res_stride is None or (res_aligned and res_stride % unit == 0)):
        return "vec16"
    return "flat16"


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, act: Act,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The epilogue of a conv run without its bias (see the module's
    docstring). On the card it writes into ``y`` and returns ``y`` (a ``y``
    in another layout is first copied to channels_last(_3d)); on the CPU,
    and through the registered ops, it returns a new tensor: use the return
    value."""
    code = act_code(act)
    if _cuda.routed_through_ops():
        if code == 2:
            return torch.ops.rva.conv_epilogue_relu(y, bias, residual)
        return torch.ops.rva.conv_epilogue(y, bias, residual, code == 1)
    if not y.is_cuda:
        if y.device.type == "cpu":
            return conv_epilogue_plain(y, bias, act, residual)
        raise ValueError(f"conv_epilogue: y must be on a CUDA device or the CPU, got {y.device}")
    y = y.contiguous(memory_format=_memory_format(y))
    return _conv_epilogue_cuda(y, y, bias, code, residual)


def _conv_epilogue_cuda(y: torch.Tensor, out: torch.Tensor, bias: torch.Tensor, act: int,
                        residual: Optional[torch.Tensor]) -> torch.Tensor:
    """The checks and the launch on CUDA tensors (the wrapper's, in place,
    and the op's, into a new ``out``)."""
    global _launch
    tensors = (y, out, bias) if residual is None else (y, out, bias, residual)
    _cuda.require_cuda("conv_epilogue", *tensors)
    if y.dtype not in DTYPES:
        raise TypeError(f"conv_epilogue: y must be bfloat16 or float32, got {y.dtype}")
    if y.dim() not in (4, 5) or not y.is_contiguous(memory_format=_memory_format(y)):
        raise ValueError("conv_epilogue: y must be a 4-d channels_last or 5-d channels_last_3d "
                         f"contiguous conv output, got shape {tuple(y.shape)} strides {y.stride()}")
    c = y.shape[1]
    if bias.shape != (c,):
        raise ValueError(f"conv_epilogue: bias must be [{c}], got {tuple(bias.shape)}")
    if c > MAX_CHANNELS:
        raise ValueError(f"conv_epilogue: at most {MAX_CHANNELS} channels, got {c}")
    if (y.data_ptr() | out.data_ptr()) % 16:
        raise ValueError("conv_epilogue: y and the output must be 16-byte aligned")
    bias = bias.to(y.dtype).contiguous()
    res_ptr, res_stride = None, 0
    if residual is not None:
        s = residual_stride(y, residual)
        if s is None:
            residual = residual.to(y.dtype).contiguous(memory_format=_memory_format(y))
            s = c
        res_ptr, res_stride = residual.data_ptr(), s
    mode = epilogue_instantiation(y.dtype, c, res_ptr is None or res_ptr % 16 == 0,
                                  None if res_ptr is None else res_stride)
    if _launch is None:
        _launch = _cuda.entry("rva_conv_epilogue")
    dev = y.get_device()
    rc = _launch(dev, y.data_ptr(), out.data_ptr(), bias.data_ptr(), res_ptr, res_stride,
                 y.numel() // c, c, act, int(y.dtype == torch.bfloat16), _MODES[mode],
                 _cuda.stream_of(dev))
    if rc:
        _cuda.fail(rc, "conv_epilogue")
    _cuda.LAUNCHES.add("conv_epilogue")
    return out


@torch.library.custom_op("rva::conv_epilogue", mutates_args=(), device_types="cpu")
def _conv_epilogue_op(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor],
                      act: bool) -> torch.Tensor:
    return conv_epilogue_plain(y, bias, "silu" if act else None, residual)


@_conv_epilogue_op.register_kernel("cuda")
def _(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor],
      act: bool) -> torch.Tensor:
    y = y.contiguous(memory_format=_memory_format(y))
    return _conv_epilogue_cuda(y, torch.empty_like(y), bias, int(act), residual)


@_conv_epilogue_op.register_fake
def _(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor],
      act: bool) -> torch.Tensor:
    return torch.empty_like(y)


@torch.library.custom_op("rva::conv_epilogue_relu", mutates_args=(), device_types="cpu")
def _conv_epilogue_relu_op(y: torch.Tensor, bias: torch.Tensor,
                           residual: Optional[torch.Tensor]) -> torch.Tensor:
    return conv_epilogue_plain(y, bias, "relu", residual)


@_conv_epilogue_relu_op.register_kernel("cuda")
def _(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor]) -> torch.Tensor:
    y = y.contiguous(memory_format=_memory_format(y))
    return _conv_epilogue_cuda(y, torch.empty_like(y), bias, 2, residual)


@_conv_epilogue_relu_op.register_fake
def _(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.empty_like(y)
