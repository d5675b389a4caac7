"""B7: a float conv's elementwise epilogue (bias, SiLU, shortcut add) in one pass.

No Pallas kernel stands behind this one: on the TPU, XLA fuses the JAX
package's conv bias and ``x * sigmoid(x)`` into the conv's own fusion. On
the card PyTorch runs a conv's bias as a pass of its own after cuDNN, then
``F.silu`` and a bottleneck's ``x + y`` as two more, so the conv's output
crosses device memory three or four times. ``conv_epilogue`` takes the
output of a conv run without its bias and does the three in one read and
one write (``csrc/epilogue.cu``), in place::

    y = round(y + bias);  y = round(silu(y)) if act;  y = round(residual + y)

each rounded to ``y``'s dtype, as the PyTorch passes round: the result is
theirs bit for bit. ``conv_epilogue_plain`` is that composition in plain
PyTorch (a new tensor); the wrapper takes it only for tensors on the CPU.

``y`` is a conv's output, NCHW-logical in ``channels_last`` memory
([N, H, W, C] contiguous), bf16 or fp32; another layout is copied to
channels_last first. (Under ``torch.export`` on the card a traced conv's
output reads NCHW-contiguous, so the layout cannot decide whether a conv
takes the epilogue.) ``residual`` has ``y``'s shape and
may be a channel-slice view of a wider channels_last tensor (C2f's
``chunk``): the kernel reads it through its pixel stride
(``residual_stride``), so it is not copied; another layout is copied to
channels_last first.

The kernel has two instantiations; ``epilogue_instantiation`` says which
a call takes: ``vec16`` (16-byte units within a pixel: C a multiple of 8 in
bf16 or 4 in fp32, a 16-byte aligned residual whose pixel stride is a
multiple of the unit) and ``flat16`` (16-byte units over the flat output,
any C: the last unit masked, the residual read element by element). Both
need ``y`` (and the op's output) 16-byte aligned, as every conv output and
fresh copy is; a misaligned one is refused.

The registered op ``rva::conv_epilogue`` (``ops/_cuda.py``) is the
functional form, which an exported step keeps as one node: on a CUDA tensor
the same launch into a new output, on a CPU one the plain version.
``conv_epilogue`` calls it inside ``_cuda.through_ops`` (an exported step).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda

DTYPES = (torch.bfloat16, torch.float32)
MAX_CHANNELS = 12288  # the bias in 48 KB of shared memory (csrc/epilogue.cu)
_MODES = {"vec16": 1, "flat16": 0}

_launch = None  # the bound C entry, set at the first launch


def conv_epilogue_plain(y: torch.Tensor, bias: torch.Tensor, act: bool,
                        residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version, any device: ``y + bias`` (per channel), then
    ``F.silu`` when ``act``, then ``residual + y``; a new tensor."""
    y = y + bias.to(y.dtype)[:, None, None]
    if act:
        y = F.silu(y)
    return y if residual is None else residual + y


def residual_stride(y: torch.Tensor, residual: torch.Tensor) -> Optional[int]:
    """The elements from one pixel of ``residual`` to the next when its
    element (n, c, h, w) lies at ``((n * H + h) * W + w) * stride + c``
    (channels_last, or a channel slice of a channels_last tensor); None for
    another layout or shape."""
    if residual.shape != y.shape or residual.dtype != y.dtype:
        return None
    n, c, h, w = y.shape
    s = residual.stride(3) if w > 1 else (residual.stride(2) if h > 1 else residual.stride(0))
    if s < c:
        return None
    want = (h * w * s, 1, w * s, s)
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


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, act: bool,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The epilogue of a conv run without its bias (see the module's
    docstring). On the card it writes into ``y`` and returns ``y`` (a ``y``
    in another layout is first copied to channels_last); on the CPU, and
    through the registered op, it returns a new tensor: use the return
    value."""
    if _cuda.routed_through_ops():
        return torch.ops.rva.conv_epilogue(y, bias, residual, act)
    if not y.is_cuda:
        if y.device.type == "cpu":
            return conv_epilogue_plain(y, bias, act, residual)
        raise ValueError(f"conv_epilogue: y must be on a CUDA device or the CPU, got {y.device}")
    y = y.contiguous(memory_format=torch.channels_last)
    return _conv_epilogue_cuda(y, y, bias, act, residual)


def _conv_epilogue_cuda(y: torch.Tensor, out: torch.Tensor, bias: torch.Tensor, act: bool,
                        residual: Optional[torch.Tensor]) -> torch.Tensor:
    """The checks and the launch on CUDA tensors (the wrapper's, in place,
    and the op's, into a new ``out``)."""
    global _launch
    tensors = (y, out, bias) if residual is None else (y, out, bias, residual)
    _cuda.require_cuda("conv_epilogue", *tensors)
    if y.dtype not in DTYPES:
        raise TypeError(f"conv_epilogue: y must be bfloat16 or float32, got {y.dtype}")
    if y.dim() != 4 or not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv_epilogue: y must be a 4-d channels_last-contiguous conv output, "
                         f"got shape {tuple(y.shape)} strides {y.stride()}")
    n, c, h, w = y.shape
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
            residual = residual.to(y.dtype).contiguous(memory_format=torch.channels_last)
            s = c
        res_ptr, res_stride = residual.data_ptr(), s
    mode = epilogue_instantiation(y.dtype, c, res_ptr is None or res_ptr % 16 == 0,
                                  None if res_ptr is None else res_stride)
    if _launch is None:
        _launch = _cuda.entry("rva_conv_epilogue")
    dev = y.get_device()
    rc = _launch(dev, y.data_ptr(), out.data_ptr(), bias.data_ptr(), res_ptr, res_stride,
                 n * h * w, c, int(act), int(y.dtype == torch.bfloat16), _MODES[mode],
                 _cuda.stream_of(dev))
    if rc:
        _cuda.fail(rc, "conv_epilogue")
    _cuda.LAUNCHES.add("conv_epilogue")
    return out


@torch.library.custom_op("rva::conv_epilogue", mutates_args=(), device_types="cpu")
def _conv_epilogue_op(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor],
                      act: bool) -> torch.Tensor:
    return conv_epilogue_plain(y, bias, act, residual)


@_conv_epilogue_op.register_kernel("cuda")
def _(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor],
      act: bool) -> torch.Tensor:
    y = y.contiguous(memory_format=torch.channels_last)
    return _conv_epilogue_cuda(y, torch.empty_like(y), bias, act, residual)


@_conv_epilogue_op.register_fake
def _(y: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor],
      act: bool) -> torch.Tensor:
    return torch.empty_like(y)
