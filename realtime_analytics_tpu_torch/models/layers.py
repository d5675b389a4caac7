"""Conv building blocks on NCHW tensors (OIHW weights, BN folded).

Counterpart of ``realtime_analytics_tpu/models/layers.py``. The model keeps
its activations NCHW-logical in ``torch.channels_last`` memory, which is
the JAX package's NHWC layout byte for byte. BatchNorm never exists at
inference time: the checkpoint loader folds it into conv weight and bias.

Numerics: a bf16 input gives a bf16 output (cuDNN accumulates in fp32), as
the JAX package's convs emit their input dtype; fp32 stays fp32 (the engine
turns TF32 off, so an fp32 conv on the card is true fp32).

int8: a ``ConvAct`` that was loaded from a quantised tree node
``{"w_q", "w_scale", "b"[, "a_scale"]}`` (``weights.quantize_params_int8``)
holds int8 weights instead of float ones and runs the full int8 conv
(``ops/int8.py``: int8 activations and weights, an int32 product,
dequantised in fp32), the JAX package's ``conv_act(act_int8=True)``.
``ConvAct.plain_weight`` dequantises the weights in bf16 (the JAX
package's ``get_weight``) for the v5 head, which stays weight-only.

The epilogue (``conv_bias_act``): on the card, where no gradient is
needed, a float conv runs without its bias and one hand-written pass
(``ops/epilogue.py``, B7) adds the bias, applies SiLU and adds a
bottleneck's shortcut, with the roundings of PyTorch's separate passes. In
every other case (the CPU, a train step) the conv takes its bias and SiLU
and the shortcut add follow as before.

Neck fusion: ``ConvAct.up_concat`` is the JAX package's
``_split_up_conv1x1_act``, a 1x1 conv over ``concat(up2x(x), y)`` computed
from the two input-channel halves of its weight, so that neither the
upsample of ``x`` nor the concat is written; ``split_input`` keeps the two
halves as contiguous buffers, made once when a serving model is prepared.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.epilogue import DTYPES as EPILOGUE_DTYPES, conv_epilogue
from ..ops.int8 import QuantConv, conv2d_int8, pack_int8_weight


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    groups: int = 1,
    padding: Optional[int] = None,
) -> torch.Tensor:
    """2D conv with torch-style symmetric padding (default k//2 "autopad")."""
    if padding is None:
        padding = w.shape[-1] // 2
    return F.conv2d(x, w, b, stride=stride, padding=padding, groups=groups)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def silu_xla(x: torch.Tensor) -> torch.Tensor:
    """SiLU as XLA expands the JAX package's ``x * sigmoid(x)``: ``x * (1 /
    (1 + exp(-x)))``, each operation rounded to ``x``'s dtype. The int8
    path uses it: the next conv rounds these values to int8 levels, where
    ``F.silu``'s single rounding (a third of bf16 values differ by one
    last bit) would flip levels that the JAX package keeps."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def conv_act(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *,
             stride: int = 1, padding: Optional[int] = None,
             act: bool = True) -> torch.Tensor:
    """YOLO "Conv" block: conv + (folded BN) + SiLU."""
    y = conv2d(x, w, b, stride=stride, padding=padding)
    return silu(y) if act else y


def fuses_epilogue(x: torch.Tensor, *operands: Optional[torch.Tensor]) -> bool:
    """A conv of ``x`` takes the epilogue kernel: ``x`` is a float tensor on
    the card and no operand needs a gradient (the kernel has no
    backward)."""
    if x.device.type != "cuda" or x.dtype not in EPILOGUE_DTYPES:
        return False
    return not (torch.is_grad_enabled()
                and any(t is not None and t.requires_grad for t in (x, *operands)))


def conv_bias_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                  stride: int = 1, padding=None, act: bool = True,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``residual + act(conv(x, w) + b)`` (no add without a residual).
    Where ``fuses_epilogue`` holds, the conv runs without its bias and the
    epilogue kernel does the rest in place on its (channels_last) output;
    else the conv takes its bias and SiLU and the add follow."""
    if fuses_epilogue(x, w, b, residual):
        return conv_epilogue(conv2d(x, w, stride=stride, padding=padding), b,
                             "silu" if act else None, residual)
    y = conv2d(x, w, b, stride=stride, padding=padding)
    y = silu(y) if act else y
    return y if residual is None else residual + y


class ConvAct(nn.Module):
    """Conv (OIHW weight) + folded-BN bias + optional SiLU (YOLO "Conv";
    ``act=False`` is a plain conv). JAX params counterpart:
    {"w": HWIO, "b": [cout]}, or the int8 form {"w_q": HWIO int8,
    "w_scale": [cout], "b": [cout], "a_scale": []} (the module then holds
    ``w_q`` OIHW, ``w_scale``, ``a_scale`` and the packed ``w_pack`` as
    buffers, and no float weight)."""

    def __init__(self, cin: int, cout: int, k: int, s: int = 1,
                 p: Optional[int] = None, act: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)
        self.register_buffer("w_q", None)
        self.register_buffer("w_scale", None)
        self.register_buffer("a_scale", None)
        self.register_buffer("w_pack", None, persistent=False)
        # the fused neck's weight halves (``split_input``): not parameters
        self.register_buffer("w_up", None, persistent=False)
        self.register_buffer("w_skip", None, persistent=False)
        self.shape = (cout, cin, k, k)
        self.stride, self.padding, self.act = s, p, act

    def plain_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The float weight in ``dtype``: the stored one, or the int8 one
        dequantised as the JAX package's ``get_weight``: ``w_q * w_scale``
        formed in bf16, then cast to ``dtype``."""
        if self.w_q is None:
            return self.weight.to(dtype)
        w = self.w_q.to(torch.bfloat16) * self.w_scale.to(torch.bfloat16)[:, None, None, None]
        return w.to(dtype)

    def quant(self) -> QuantConv:
        return QuantConv(self.w_pack, self.w_scale, self.a_scale)

    def forward(self, x: torch.Tensor,
                weight: Union[torch.Tensor, QuantConv, None] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``weight`` overrides the stored weight: a float tensor for a
        float conv, a ``QuantConv`` for an int8 one. ``residual``: a
        bottleneck's shortcut, added last (``residual + y``)."""
        if self.w_q is not None:
            y = conv2d_int8(x, self.quant() if weight is None else weight, self.bias,
                            self.shape[0], self.shape[-1], stride=self.stride,
                            padding=self.padding)
            y = silu_xla(y) if self.act else y
            return y if residual is None else residual + y
        return conv_bias_act(x, self.weight if weight is None else weight, self.bias,
                             stride=self.stride, padding=self.padding, act=self.act,
                             residual=residual)

    def split_input(self, ch: int) -> None:
        """Keep the weight's input channels ``[:ch]`` and ``[ch:]`` as two
        contiguous buffers for ``up_concat`` (a serving model's, made once;
        a new load drops them)."""
        w = self.weight.detach()
        self.w_up = w[:, :ch].contiguous(memory_format=torch.channels_last)
        self.w_skip = w[:, ch:].contiguous(memory_format=torch.channels_last)

    def up_concat(self, x_small: torch.Tensor, y_skip: torch.Tensor) -> torch.Tensor:
        """This 1x1 conv + SiLU over ``concat(up2x(x_small), y_skip)``
        without the upsample or the concat in memory (the nearest upsample
        commutes with a 1x1 conv): ``a = conv(x_small, w[:, :ch])``, ``b =
        conv(y_skip, w[:, ch:]) + bias``, ``silu(up2x(a) + b)``, each
        rounded to the input's dtype in that order, as the JAX package's
        ``_split_up_conv1x1_act``. A weight that takes gradients is split by
        views (autograd runs through them); a serving one uses the halves
        of ``split_input`` when it has them."""
        ch = x_small.shape[1]
        if self.w_up is not None and not self.weight.requires_grad:
            w_a, w_b = self.w_up, self.w_skip
        else:
            w_a, w_b = self.weight[:, :ch], self.weight[:, ch:]
        a = conv2d(x_small, w_a.to(x_small.dtype))
        w_b = w_b.to(y_skip.dtype)
        b = conv2d(y_skip, w_b)
        b = (conv_epilogue(b, self.bias, None) if fuses_epilogue(y_skip, w_b, self.bias)
             else b + self.bias.to(y_skip.dtype)[:, None, None])
        return silu(upsample2x(a) + b)

    def load_tree(self, node: Mapping, path: str) -> None:
        self.w_up = self.w_skip = None
        if "w_q" not in node:
            if self.w_q is not None:
                raise ValueError(f"{path}: the module holds int8 weights; load float "
                                 "weights into a new model")
            load_param(self.weight, np.asarray(node["w"], np.float32).transpose(3, 2, 0, 1),
                       path)
            load_param(self.bias, node["b"], path)
            return
        w_q = np.asarray(node["w_q"])
        if w_q.dtype != np.int8 or w_q.transpose(3, 2, 0, 1).shape != self.shape:
            raise ValueError(f"{path}: w_q {w_q.dtype} {w_q.shape} does not fit the "
                             f"module's {self.shape}")
        dev = self.bias.device
        self.weight = None
        self.w_q = torch.from_numpy(w_q.transpose(3, 2, 0, 1).copy()).to(dev)
        self.w_scale = torch.from_numpy(np.array(node["w_scale"], np.float32)).to(dev)
        self.a_scale = (torch.tensor(np.float32(node["a_scale"]), device=dev)
                        if "a_scale" in node else None)
        self.w_pack = pack_int8_weight(self.w_q)
        load_param(self.bias, node["b"], path)

    def to_tree(self) -> Dict[str, np.ndarray]:
        if self.w_q is None:
            return {"w": to_numpy(self.weight).transpose(2, 3, 1, 0).copy(),
                    "b": to_numpy(self.bias)}
        tree = {"w_q": self.w_q.cpu().numpy().transpose(2, 3, 1, 0).copy(),
                "w_scale": to_numpy(self.w_scale), "b": to_numpy(self.bias)}
        if self.a_scale is not None:
            tree["a_scale"] = to_numpy(self.a_scale)
        return tree


class Dense(nn.Module):
    """``x @ w + b``. JAX params counterpart: {"w": [in, out], "b": [out]}.
    The weights take the input's dtype, as JAX promotes a bf16 weight
    against an fp32 input (the temporal heads run in fp32)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))

    def load_tree(self, node: Mapping, path: str) -> None:
        load_param(self.weight, np.asarray(node["w"], np.float32).T, path)
        load_param(self.bias, node["b"], path)

    def to_tree(self) -> Dict[str, np.ndarray]:
        return {"w": to_numpy(self.weight).T.copy(), "b": to_numpy(self.bias)}


def load_param(param: torch.Tensor, value, path: str) -> None:
    """Copy a numpy value into a parameter in place (keeping its dtype and
    device); the shapes must match exactly."""
    value = np.array(value, dtype=np.float32)  # a writable copy
    if value.shape != tuple(param.shape):
        raise ValueError(
            f"{path}: tree shape {value.shape} does not match the module's "
            f"{tuple(param.shape)}"
        )
    with torch.no_grad():
        param.copy_(torch.from_numpy(value))


def to_numpy(param: torch.Tensor) -> np.ndarray:
    return param.detach().float().cpu().numpy().copy()


def max_pool(x: torch.Tensor, k: int, stride: int = 1) -> torch.Tensor:
    """Max pooling with torch-parity padding: odd kernels pad k//2 (SPPF's
    MaxPool2d(k, padding=k//2)), even kernels pad 0 (MaxPool2d's default)."""
    pad = k // 2 if k % 2 else 0
    return F.max_pool2d(x, kernel_size=k, stride=stride, padding=pad)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (nn.Upsample(scale_factor=2))."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def make_divisible(v: float, divisor: int = 8) -> int:
    """Round channel counts up to a multiple of ``divisor`` (matches the
    channel arithmetic of published YOLO configs)."""
    return int(np.ceil(v / divisor) * divisor)
