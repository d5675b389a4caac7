"""ONNX graph -> PyTorch: the generic-graph serving path.

Counterpart of ``realtime_analytics_tpu/models/onnx_jax.py``. The
reference's ONNX Runtime / OpenVINO backends serve *arbitrary* user ONNX
graphs (reference detector.py:484-609, temporal_detector.py:179-319). The
named checkpoint loaders in ``models/weights.py`` cover the documented
layouts; this module covers everything else: it runs the ONNX **graph
itself** (parsed by ``onnx_lite.read_onnx_model``) as torch operations, so
a user file that matches no known layout still serves on the card.

Design, op for op the JAX package's:

* Every live op lowers to plain torch (``F.conv2d``, pools, ``matmul``,
  elementwise ops, a Python time loop for LSTM/GRU with the input
  projection hoisted out of it). Integer products stay exact: cuDNN has no
  int8 convolution, so ``ConvInteger``/``QLinearConv`` run as an im2col and
  an int32 product (``ops.int8.int8_matmul``, ``torch._int_mm``).
* Constant/live split (``_run``): a node whose inputs are all numpy folds
  through ``onnx_exec._eval_node``; ``Shape`` of a live tensor returns its
  concrete shape as numpy, so shape machinery downstream stays numpy and
  folds; a node touching a torch tensor lowers to torch (``_LOWER``).
  Float initializers reach the graph as live tensors (the adapters'
  ``serving_params``); integer shape tensors and Resize scales stay numpy.
* dtypes follow JAX with 64-bit mode off for floats: a float64 constant
  or a Cast to float64 computes in float32. Integers keep torch's widths
  (int64 indices); values, not widths, are the contract.
* ``graph_compute_dtype(torch.bfloat16)`` is the opt-in mixed policy of
  ``detector.graph_precision: bf16``: Conv/ConvTranspose/MatMul/Gemm/Einsum
  and the pointwise activations take bf16 operands and emit bf16; norms,
  softmax, reductions, average pools, recurrent scans and ``Pow`` compute
  in fp32; every live float output is cast back to bf16.

Plan once per input shape. JAX pays for its per-node Python interpreter
once, at trace time; eager torch would pay for it on every call (the
scheduler, the numpy folds of Shape chains, the dict lookups). So
``compile_graph`` returns a ``CompiledGraph`` that, at the first call for a
given set of feed shapes, dtypes and devices (and compute policy), runs the
interpreter once and records a plan: the folded constants, the flat list of
live nodes in execution order with their lowerings resolved, and a cache of
the device copies of the numpy constants those nodes read. Later calls at
that key run only the list. The planned run executes the same lowerings on
the same values in the same order, so its outputs are those of the
unplanned interpreter (``CompiledGraph.unplanned``), bit for bit.

Usage::

    fn = compile_graph(read_onnx_model(path))      # fn: feeds dict -> [outs]
    outs = fn({"images": x, **params})
"""

from __future__ import annotations

import contextlib
import logging
from contextvars import ContextVar
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.int8 import int8_matmul
from .onnx_exec import UnsupportedOnnxOp, _eval_node
from .onnx_lite import OnnxGraph, OnnxNode

logger = logging.getLogger(__name__)

# Active mixed-precision policy: None (the default) serves the graph in its
# exported dtype, fp32 end to end; torch.bfloat16 is the opt-in policy
# described in the module docstring (onnx_jax._COMPUTE).
_COMPUTE: ContextVar = ContextVar("onnx_graph_compute_dtype", default=None)
# A plan's cache of device copies of numpy constants (None: no cache, the
# unplanned interpreter converts at every use).
_CACHE: ContextVar = ContextVar("onnx_graph_constant_cache", default=None)


@contextlib.contextmanager
def graph_compute_dtype(dtype):
    """Precision policy scope; fp32 (or None) = the exact path, bf16 = the
    mixed policy."""
    tok = _COMPUTE.set(None if dtype in (None, torch.float32) else dtype)
    try:
        yield
    finally:
        _COMPUTE.reset(tok)


# ONNX TensorProto.DataType codes used by Cast (uint32/64: int64 keeps the
# values)
_CAST_DTYPES = {
    1: torch.float32, 2: torch.uint8, 3: torch.int8, 5: torch.int16,
    6: torch.int32, 7: torch.int64, 9: torch.bool, 10: torch.float16,
    11: torch.float32, 12: torch.int64, 13: torch.int64,
}
_QUANT_DTYPES = {np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8}


def _attr(node, name, default=None):
    return node.attrs.get(name, default)


def _is_static(v) -> bool:
    """numpy / Python value (folds) vs torch tensor (live)."""
    return not isinstance(v, torch.Tensor)


_NP_CANON = {np.dtype(np.float64): np.float32, np.dtype(np.uint32): np.int64,
             np.dtype(np.uint64): np.int64}


def to_torch(v, device=None) -> torch.Tensor:
    """A numpy array or Python number as a tensor (float64 -> float32,
    uint32/uint64 -> int64)."""
    a = np.asarray(v)
    a = np.ascontiguousarray(a, dtype=_NP_CANON.get(a.dtype, a.dtype))
    t = torch.from_numpy(a if a.flags.writeable else a.copy())
    return t if device is None else t.to(device)


def _as(v, ref: torch.Tensor) -> torch.Tensor:
    """``v`` as a tensor on ``ref``'s device. Inside a plan, a numpy
    constant is copied to the device once (the plan's cache holds the array
    too, so its id cannot be reused while cached)."""
    if isinstance(v, torch.Tensor):
        return v
    cache = _CACHE.get()
    if cache is None or not isinstance(v, np.ndarray):
        return to_torch(v, ref.device)
    key = (id(v), ref.device)
    hit = cache.get(key)
    if hit is None or hit[0] is not v:
        hit = cache[key] = (v, to_torch(v, ref.device))
    return hit[1]


def _cached(key, make):
    """A per-plan constant (index tables, weights) built once by ``make``."""
    cache = _CACHE.get()
    if cache is None:
        return make()
    hit = cache.get(key)
    if hit is None:
        hit = cache[key] = make()
    return hit


def _live(ins) -> torch.Tensor:
    for v in ins:
        if isinstance(v, torch.Tensor):
            return v
    raise AssertionError("a lowered node has no live input")  # _run guarantees one


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def _mxu(x: torch.Tensor) -> torch.Tensor:
    """Matrix-op and pointwise operand: bf16 under the bf16 policy (float
    inputs), else fp32 (``onnx_jax._mxu``)."""
    cd = _COMPUTE.get()
    if cd is not None and x.is_floating_point():
        return x if x.dtype == cd else x.to(cd)
    return _f32(x)


def _acc(x: torch.Tensor) -> torch.Tensor:
    """Accumulation-sensitive input: fp32 under the bf16 policy, as is
    otherwise (``onnx_jax._acc``)."""
    if _COMPUTE.get() is not None and x.is_floating_point():
        return _f32(x)
    return x


def _ints(v) -> List[int]:
    return [int(s) for s in np.asarray(v).reshape(-1)]


def _scalar(v) -> float:
    return np.asarray(v).reshape(-1)[0].item()


def _need_static(op, v, what):
    if not _is_static(v):
        raise UnsupportedOnnxOp(
            f"{op}: {what} is data-dependent (a live tensor) — the graph "
            "needs static shapes"
        )
    return v


def _opt(ins, i):
    return ins[i] if len(ins) > i and ins[i] is not None else None


# ---------------------------------------------------------------------------
# convolutions, pools, resize
# ---------------------------------------------------------------------------


def _conv_attrs(node, k):
    if _attr(node, "auto_pad", "NOTSET") not in ("NOTSET", ""):
        raise UnsupportedOnnxOp(f"{node.op_type} auto_pad")
    strides = [int(s) for s in _attr(node, "strides", [1] * k)]
    pads = [int(p) for p in _attr(node, "pads", [0] * (2 * k))]
    dils = [int(d) for d in _attr(node, "dilations", [1] * k)]
    return strides, pads, dils, int(_attr(node, "group", 1))


def _pad_arg(pads, k):
    """ONNX [b1.., e1..] -> F.pad's last-dim-first (b, e) list."""
    out = []
    for d in reversed(range(k)):
        out += [pads[d], pads[k + d]]
    return out


def _conv(node, ins):
    x = _live(ins)
    k = x.ndim - 2
    if k not in (2, 3):
        raise UnsupportedOnnxOp(f"Conv over {k}D input")
    strides, pads, dils, groups = _conv_attrs(node, k)
    x = _mxu(x)
    w = _mxu(_as(ins[1], x))
    b = _opt(ins, 2)
    if b is not None:
        b = _as(b, x).to(x.dtype)
    if pads[:k] == pads[k:]:
        padding = pads[:k]
    else:
        x = F.pad(x, _pad_arg(pads, k))
        padding = 0
    conv = F.conv2d if k == 2 else F.conv3d
    return conv(x, w, b, strides, padding, dils, groups)


def _conv_transpose(node, ins):
    """ONNX ConvTranspose: torch's transposed conv with no padding, then the
    ONNX pads cropped and ``output_padding`` zero-extended at the end, then
    the bias (``onnx_jax._conv_transpose``'s lhs-dilated conv computes the
    same sums)."""
    x = _live(ins)
    k = x.ndim - 2
    if k not in (2, 3):
        raise UnsupportedOnnxOp(f"ConvTranspose over {k}D input")
    strides, pads, dils, groups = _conv_attrs(node, k)
    if _attr(node, "output_shape") is not None:
        raise UnsupportedOnnxOp("ConvTranspose output_shape")
    out_pad = [int(p) for p in _attr(node, "output_padding", [0] * k)]
    x = _mxu(x)
    w = _mxu(_as(ins[1], x))
    ks = tuple(w.shape[2:])
    k_eff = [(ki - 1) * d + 1 for ki, d in zip(ks, dils)]
    if any(ke - 1 - pb < 0 or ke - 1 - pe + op_ < 0 for ke, pb, pe, op_ in
           zip(k_eff, pads[:k], pads[k:], out_pad)):
        raise UnsupportedOnnxOp("ConvTranspose pads exceed kernel extent")
    convt = F.conv_transpose2d if k == 2 else F.conv_transpose3d
    y = convt(x, w, None, strides, 0, 0, groups, dils)
    crop = []
    for d in reversed(range(k)):
        crop += [-pads[d], out_pad[d] - pads[k + d]]
    if any(crop):
        y = F.pad(y, crop)
    b = _opt(ins, 2)
    if b is not None:
        y = y + _as(b, y).to(y.dtype).reshape((1, -1) + (1,) * k)
    return y


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _window_sum(xf, kernel, strides):
    """Sum over VALID windows (``lax.reduce_window`` add)."""
    k = len(kernel)
    if k == 1:  # avg_pool1d has no divisor_override
        return F.avg_pool2d(xf.unsqueeze(-1), (kernel[0], 1), (strides[0], 1),
                            divisor_override=1).squeeze(-1)
    return _AVG_POOL[k](xf, kernel, strides, divisor_override=1)


def _pool(node, ins, op):
    x = _live(ins)
    kernel = [int(v) for v in _attr(node, "kernel_shape")]
    k = len(kernel)
    if _attr(node, "auto_pad", "NOTSET") not in ("NOTSET", ""):
        raise UnsupportedOnnxOp(f"{node.op_type} auto_pad")
    strides = [int(s) for s in _attr(node, "strides", [1] * k)]
    pads = [int(p) for p in _attr(node, "pads", [0] * (2 * k))]
    dils = [int(d) for d in _attr(node, "dilations", [1] * k)]
    if op == "avg" and any(d != 1 for d in dils):
        raise UnsupportedOnnxOp("AveragePool dilations")
    ceil_mode = int(_attr(node, "ceil_mode", 0))
    if op == "avg" and int(_attr(node, "count_include_pad", 0)) == 0 and any(pads):
        raise UnsupportedOnnxOp("AveragePool count_include_pad=0 w/ pads")
    ek = [(kernel[i] - 1) * dils[i] + 1 for i in range(k)]
    in_sp = x.shape[2:]
    begins, ends = list(pads[:k]), list(pads[k:])
    ext = [0] * k
    out_keep = None
    if ceil_mode:
        for i in range(k):
            span = in_sp[i] + begins[i] + ends[i]
            if (span - ek[i]) % strides[i]:
                ext[i] = -(span - ek[i]) % strides[i]
        # ONNX/torch drop rule: ceil-extended windows must START inside
        # in + pad_begin (onnx_exec._poolnd carries the derivation)
        out_keep = tuple(
            sum(1 for j in range((in_sp[d] + begins[d] + ends[d] + ext[d] - ek[d])
                                 // strides[d] + 1)
                if j * strides[d] < in_sp[d] + begins[d])
            for d in range(k))
    fill = float("-inf") if op == "max" else 0.0
    # max pool is order-insensitive: it rides the policy dtype; avg pool
    # accumulates, so it stays fp32
    xf = _mxu(x) if op == "max" else _f32(x)
    full = [b_ + e_ + x_ for b_, e_, x_ in zip(begins, ends, ext)]
    if any(full):
        xf = F.pad(xf, _pad_arg(begins + [e + x_ for e, x_ in zip(ends, ext)], k),
                   value=fill)
    if op == "max":
        y = _MAX_POOL[k](xf, kernel, strides, 0, dils)
    else:
        y = _window_sum(xf, kernel, strides)
        if any(ext):
            def counts():
                ones = torch.ones((1, 1) + tuple(xf.shape[2 + d] - ext[d] for d in range(k)),
                                  dtype=xf.dtype, device=xf.device)
                ones = F.pad(ones, _pad_arg([0] * k + ext, k))
                return _window_sum(ones, kernel, strides)

            y = y / _cached(("pool_count", id(node), tuple(xf.shape), xf.device), counts)
        else:
            y = y / float(np.prod(kernel))
    if out_keep is not None:
        y = y[(slice(None),) * 2 + tuple(slice(0, o) for o in out_keep)]
    return y


def _resize_tables(node, h, w, scales, sizes, device):
    mode = _attr(node, "mode", "nearest")
    coord = _attr(node, "coordinate_transformation_mode", "half_pixel")
    nearest_mode = _attr(node, "nearest_mode", "round_prefer_floor")
    if sizes is not None and np.size(sizes):
        oh, ow = int(sizes[-2]), int(sizes[-1])
        sc_h, sc_w = oh / h, ow / w
    else:
        sc_h, sc_w = float(scales[-2]), float(scales[-1])
        oh, ow = int(np.floor(h * sc_h)), int(np.floor(w * sc_w))

    def src_coord(i, scale, in_len, out_len):
        if coord == "asymmetric":
            return i / scale
        if coord in ("pytorch_half_pixel", "half_pixel"):
            xs = (i + 0.5) / scale - 0.5
            if coord == "pytorch_half_pixel" and out_len <= 1:
                return np.zeros_like(xs)
            return xs
        if coord == "align_corners":
            if out_len == 1:
                return np.zeros_like(i)
            return i * (in_len - 1) / (out_len - 1)
        raise UnsupportedOnnxOp(f"Resize coord mode '{coord}'")

    # the index math is static: numpy in float64, as the JAX package's
    ys = src_coord(np.arange(oh, dtype=np.float64), sc_h, h, oh)
    xs = src_coord(np.arange(ow, dtype=np.float64), sc_w, w, ow)

    def idx(a):
        return torch.from_numpy(a.astype(np.int64)).to(device)

    if mode == "nearest":
        if nearest_mode == "floor":
            yi, xi = np.floor(ys), np.floor(xs)
        elif nearest_mode == "ceil":
            yi, xi = np.ceil(ys), np.ceil(xs)
        elif nearest_mode == "round_prefer_ceil":
            yi, xi = np.floor(ys + 0.5), np.floor(xs + 0.5)
        else:  # round_prefer_floor (default)
            yi, xi = np.ceil(ys - 0.5), np.ceil(xs - 0.5)
        return mode, idx(np.clip(yi, 0, h - 1)), idx(np.clip(xi, 0, w - 1))
    if mode == "linear":
        y0 = np.clip(np.floor(ys), 0, h - 1).astype(np.int64)
        y1 = np.clip(y0 + 1, 0, h - 1)
        x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int64)
        x1 = np.clip(x0 + 1, 0, w - 1)
        wy = torch.from_numpy(np.clip(ys - y0, 0.0, 1.0).astype(np.float32)).to(device)
        wx = torch.from_numpy(np.clip(xs - x0, 0.0, 1.0).astype(np.float32)).to(device)
        return mode, (idx(y0), idx(y1), wy), (idx(x0), idx(x1), wx)
    raise UnsupportedOnnxOp(f"Resize mode '{mode}'")


def _resize(node, ins):
    x = _live(ins)
    if x.ndim != 4:
        raise UnsupportedOnnxOp(
            f"Resize over {x.ndim - 2} spatial dims (only 2-D supported)")
    scales = ins[2] if len(ins) > 2 and ins[2] is not None and np.size(ins[2]) else None
    sizes = _opt(ins, 3)
    if scales is not None:
        scales = _need_static("Resize", scales, "scales")
    if sizes is not None:
        sizes = _need_static("Resize", sizes, "sizes")
    h, w = x.shape[2], x.shape[3]
    mode, ty, tx = _cached(
        ("resize", id(node), h, w, x.device),
        lambda: _resize_tables(node, h, w, scales, sizes, x.device))
    if mode == "nearest":
        return x.index_select(2, ty).index_select(3, tx)
    (y0, y1, wy), (x0, x1, wx) = ty, tx
    xf = _f32(x)
    r0, r1 = xf.index_select(2, y0), xf.index_select(2, y1)
    top = r0.index_select(3, x0) * (1 - wx) + r0.index_select(3, x1) * wx
    bot = r1.index_select(3, x0) * (1 - wx) + r1.index_select(3, x1) * wx
    return top * (1 - wy[:, None]) + bot * wy[:, None]


# ---------------------------------------------------------------------------
# shape-like ops
# ---------------------------------------------------------------------------


def _slice_op(data, starts, ends, axes, steps):
    if axes is None:
        axes = list(range(len(starts)))
    if steps is None:
        steps = [1] * len(starts)
    out = data
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = int(ax) % data.ndim
        sl = slice(int(st), int(en), int(sp))
        if int(sp) > 0:
            out = out[(slice(None),) * ax + (sl,)]
        else:  # torch slicing takes no negative step: gather the indices
            idx = np.arange(*sl.indices(out.shape[ax]), dtype=np.int64)
            out = out.index_select(ax, torch.from_numpy(idx).to(out.device))
    return out


def _split(node, ins):
    x = _live(ins)
    axis = int(_attr(node, "axis", 0))
    split = _attr(node, "split")
    if split is None and _opt(ins, 1) is not None:
        split = _ints(_need_static("Split", ins[1], "split sizes"))
    if split is None:
        k = int(_attr(node, "num_outputs", len(node.outputs)))
        length = x.shape[axis]
        base = -(-length // k)
        split = [base] * (k - 1) + [length - base * (k - 1)]
    return tuple(torch.split(x, [int(s) for s in split], dim=axis))


def _slice(node, ins):
    x = _as(ins[0], _live(ins))
    if "starts" in node.attrs:  # opset < 10
        return _slice_op(x, _attr(node, "starts"), _attr(node, "ends"),
                         _attr(node, "axes"), None)
    starts = _need_static("Slice", ins[1], "starts")
    ends = _need_static("Slice", ins[2], "ends")
    axes = _ints(_need_static("Slice", ins[3], "axes")) if _opt(ins, 3) is not None else None
    steps = _ints(_need_static("Slice", ins[4], "steps")) if _opt(ins, 4) is not None else None
    return _slice_op(x, _ints(starts), _ints(ends), axes, steps)


def _reshape(node, ins):
    shape = _ints(_need_static("Reshape", ins[1], "target shape"))
    x = _live(ins)
    if int(_attr(node, "allowzero", 0)) == 0:
        shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return x.reshape(shape)


def _squeeze(node, ins):
    x = _live(ins)
    axes = _attr(node, "axes")
    if axes is None and _opt(ins, 1) is not None:
        axes = _ints(_need_static("Squeeze", ins[1], "axes"))
    if not axes:
        return x.squeeze()
    return x.squeeze(tuple(int(a) % x.ndim for a in axes))


def _unsqueeze(node, ins):
    out = _live(ins)
    axes = _attr(node, "axes")
    if axes is None:
        axes = _ints(_need_static("Unsqueeze", ins[1], "axes"))
    out_rank = out.ndim + len(axes)
    for a in sorted(int(a) % out_rank for a in axes):
        out = out.unsqueeze(a)
    return out


def _gather(node, ins):
    ref = _live(ins)
    x = _as(ins[0], ref)
    axis = int(_attr(node, "axis", 0)) % x.ndim
    n = x.shape[axis]
    idx = ins[1]
    if _is_static(idx):
        a = np.asarray(idx).astype(np.int64)
        shape = a.shape
        idx = _cached(("gather", id(node), n, ref.device),
                      lambda: torch.from_numpy(np.where(a < 0, a + n, a).reshape(-1)).to(ref.device))
    else:
        shape = tuple(idx.shape)
        idx = idx.long()
        idx = torch.where(idx < 0, idx + n, idx).reshape(-1)
    out = x.index_select(axis, idx)
    return out.reshape(tuple(x.shape[:axis]) + tuple(shape) + tuple(x.shape[axis + 1:]))


def _pad(node, ins):
    x = _live(ins)
    mode = _attr(node, "mode", "constant")
    if "pads" in node.attrs:  # opset < 11
        pads = [int(p) for p in _attr(node, "pads")]
        cval = _attr(node, "value", 0.0)
        axes = None
    else:
        pads = _ints(_need_static("Pad", ins[1], "pads"))
        cval = ins[2] if _opt(ins, 2) is not None else 0.0
        axes = _ints(_need_static("Pad", ins[3], "axes")) if _opt(ins, 3) is not None else None
    if axes is None:
        axes = list(range(x.ndim))
    half = len(pads) // 2
    cfg = [(0, 0)] * x.ndim
    for i, ax in enumerate(axes):
        cfg[ax % x.ndim] = (pads[i], pads[half + i])
    if mode == "constant":
        value = _scalar(_need_static("Pad", cval, "constant value"))
        flat = []
        for b_, e_ in reversed(cfg):
            flat += [b_, e_]
        return F.pad(x, flat, value=value)
    npmode = {"reflect": "reflect", "edge": "edge", "wrap": "wrap"}.get(mode)
    if npmode is None:
        raise UnsupportedOnnxOp(f"Pad mode '{mode}'")
    out = x
    for ax, (b_, e_) in enumerate(cfg):
        if b_ or e_:  # numpy's own index rule for the mode, gathered
            idx = np.pad(np.arange(out.shape[ax]), (b_, e_), mode=npmode)
            out = out.index_select(ax, torch.from_numpy(idx).to(out.device))
    return out


def _cumsum(node, ins):
    x = _live(ins)
    axis = int(np.asarray(_need_static("CumSum", ins[1], "axis")).item())
    rev = int(_attr(node, "reverse", 0))
    if rev:
        x = torch.flip(x, (axis,))
    r = torch.cumsum(x, dim=axis, dtype=x.dtype)
    if int(_attr(node, "exclusive", 0)):
        r = torch.cat([torch.zeros_like(r.narrow(axis, 0, 1)),
                       r.narrow(axis, 0, x.shape[axis] - 1)], dim=axis)
    if rev:
        r = torch.flip(r, (axis,))
    return r


def _topk(node, ins):
    x = _live(ins)
    k = int(np.asarray(_need_static("TopK", ins[1], "k")).item())
    axis = int(_attr(node, "axis", -1)) % x.ndim
    largest = int(_attr(node, "largest", 1))
    # a stable sort: equal values keep the lower index first, as lax.top_k
    # and the oracle's stable argsort (and ONNX Runtime)
    vals, idx = torch.sort(x, dim=axis, descending=bool(largest), stable=True)
    return vals.narrow(axis, 0, k), idx.narrow(axis, 0, k).to(torch.int64)


def _reduce(node, ins, fn_name):
    x = _live(ins)
    axes = _attr(node, "axes")
    if axes is None and _opt(ins, 1) is not None:
        axes = _ints(_need_static(node.op_type, ins[1], "axes"))
    keep = bool(int(_attr(node, "keepdims", 1)))
    dims = tuple(int(a) % x.ndim for a in axes) if axes else tuple(range(x.ndim))
    if fn_name == "l2":
        return torch.sqrt(torch.sum(torch.square(_f32(x)), dim=dims, keepdim=keep))
    if fn_name == "prod":
        y = _acc(x)
        for d in sorted(dims, reverse=True):
            y = torch.prod(y, dim=d, keepdim=True)
        return y if keep else y.squeeze(dims)
    if fn_name in ("mean", "sum"):
        x = _acc(x)
        return (torch.mean if fn_name == "mean" else torch.sum)(x, dim=dims, keepdim=keep)
    return (torch.amax if fn_name == "max" else torch.amin)(x, dim=dims, keepdim=keep)


# ---------------------------------------------------------------------------
# recurrent ops
# ---------------------------------------------------------------------------


def _rnn_scan(node, ins, kind):
    """ONNX LSTM ('iofc') / GRU ('zrh') as a loop over time with the input
    projection hoisted out of it (one batched matmul); only the hidden
    recurrence loops. Mirrors onnx_jax._rnn_scan."""
    if _attr(node, "activations") is not None:
        raise UnsupportedOnnxOp(f"{kind} custom activations")
    if int(_attr(node, "layout", 0)) != 0:
        raise UnsupportedOnnxOp(f"{kind} layout=1")
    ref = _live(ins)
    n_gates = 4 if kind == "LSTM" else 3
    x, w, r = (_f32(_as(a, ref)) for a in ins[:3])
    t_len, n = x.shape[0], x.shape[1]
    num_dirs, hid = r.shape[0], r.shape[2]
    b = _f32(_as(ins[3], ref)) if _opt(ins, 3) is not None \
        else torch.zeros((num_dirs, 2 * n_gates * hid), dtype=torch.float32, device=x.device)
    seq_lens = _opt(ins, 4)
    if seq_lens is not None and (not _is_static(seq_lens)
                                 or not np.all(np.asarray(seq_lens) == t_len)):
        raise UnsupportedOnnxOp(f"{kind} per-sequence lengths")
    h0 = _f32(_as(ins[5], ref)) if _opt(ins, 5) is not None \
        else torch.zeros((num_dirs, n, hid), dtype=torch.float32, device=x.device)
    if kind == "LSTM":
        if _opt(ins, 7) is not None:
            raise UnsupportedOnnxOp("LSTM peepholes")
        c0 = _f32(_as(ins[6], ref)) if _opt(ins, 6) is not None \
            else torch.zeros((num_dirs, n, hid), dtype=torch.float32, device=x.device)
    lbr = int(_attr(node, "linear_before_reset", 0))
    direction = _attr(node, "direction", "forward")
    dir_plan = {"forward": [(0, False)], "reverse": [(0, True)],
                "bidirectional": [(0, False), (1, True)]}.get(direction)
    if dir_plan is None:
        raise UnsupportedOnnxOp(f"RNN direction '{direction}'")

    ys, hs, cs = [], [], []
    for slot, reverse in dir_plan:
        rT = r[slot].T  # [H, nG*H]
        order = range(t_len - 1, -1, -1) if reverse else range(t_len)
        out: List[Optional[torch.Tensor]] = [None] * t_len
        if kind == "LSTM":
            gx = x @ w[slot].T + (b[slot, :4 * hid] + b[slot, 4 * hid:])  # [T, N, 4H] iofc
            h, c = h0[slot], c0[slot]
            for t in order:
                g = gx[t] + h @ rT
                i = torch.sigmoid(g[:, :hid])
                o = torch.sigmoid(g[:, hid:2 * hid])
                f = torch.sigmoid(g[:, 2 * hid:3 * hid])
                ct = torch.tanh(g[:, 3 * hid:])
                c = f * c + i * ct
                h = o * torch.tanh(c)
                out[t] = h
            hs.append(h)
            cs.append(c)
        else:
            gx = x @ w[slot].T + b[slot, :3 * hid]  # [T, N, 3H] zrh
            rb = b[slot, 3 * hid:]
            h = h0[slot]
            for t in order:
                g_t = gx[t]
                # lbr=1 needs all 3H recurrent columns; lbr=0's candidate
                # applies R after the reset gate, so only z/r's 2H here
                gh = h @ (rT if lbr else rT[:, :2 * hid])
                z = torch.sigmoid(g_t[:, :hid] + gh[:, :hid] + rb[:hid])
                rt = torch.sigmoid(g_t[:, hid:2 * hid] + gh[:, hid:2 * hid] + rb[hid:2 * hid])
                if lbr:
                    hh = torch.tanh(g_t[:, 2 * hid:] + rt * (gh[:, 2 * hid:] + rb[2 * hid:]))
                else:
                    hh = torch.tanh(g_t[:, 2 * hid:] + (rt * h) @ rT[:, 2 * hid:]
                                    + rb[2 * hid:])
                h = (1.0 - z) * hh + z * h
                out[t] = h
            hs.append(h)
        ys.append(torch.stack(out, dim=0))  # [T, N, H]
    y = torch.stack(ys, dim=1)  # [T, D, N, H]
    y_h = torch.stack(hs, dim=0)
    if kind == "LSTM":
        return y, y_h, torch.stack(cs, dim=0)
    return y, y_h


# ---------------------------------------------------------------------------
# quantized ops: exact integer products
# ---------------------------------------------------------------------------


def _quant_axis(nd, scale, zp, axis, ref):
    """onnx_jax._quant_axis_j: a Q/DQ scale and zero point (scalar or 1-D
    per axis) shaped to broadcast against a rank-``nd`` tensor."""
    s = _as(scale, ref).to(torch.float32)
    if s.ndim > 1:
        raise UnsupportedOnnxOp("blocked quantization (scale rank > 1)")
    z = _as(0 if zp is None else zp, ref).to(torch.int32)
    if s.ndim == 1 and s.shape[0] > 1:
        shape = [1] * nd
        shape[axis if axis >= 0 else axis + nd] = s.shape[0]
        s = s.reshape(shape)
        if z.numel() > 1:
            z = z.reshape(shape)
    return s, z


def _qdt(zp) -> np.dtype:
    """Quantized output dtype: the zero point's, or the uint8 default."""
    if zp is None:
        return np.dtype(np.uint8)
    if isinstance(zp, torch.Tensor):
        return {v: k for k, v in _QUANT_DTYPES.items()}[zp.dtype]
    return np.dtype(zp.dtype)


def _to_s8(x: torch.Tensor):
    """u8 / s8 -> (s8 tensor, the zero-point shift applied): uint8 values
    shift by -128, exact in int8, so every integer product is s8 x s8."""
    if x.dtype == torch.uint8:
        return (x.to(torch.int32) - 128).to(torch.int8), 128
    if x.dtype == torch.int8:
        return x, 0
    raise UnsupportedOnnxOp(f"integer op on {x.dtype} operand")


def _zp_arr(zp, shift, ref) -> torch.Tensor:
    return _as(0 if zp is None else zp, ref).to(torch.int32) - shift


def _zero_static(zp) -> bool:
    return zp is None or (_is_static(zp) and not np.any(np.asarray(zp)))


def _matmul_int(a, b, azp, bzp):
    """``(a - a_zp) @ (b - b_zp)`` in int32 with int8 operands: the main
    product is exact (``int8_matmul``); the zero-point cross terms are row
    and column sums. Twin of ``onnx_jax._matmul_int_j``; 1-D operands
    follow numpy matmul (promote, then squeeze)."""
    ref = _live([a, b])
    a8, ash = _to_s8(_as(a, ref))
    b8, bsh = _to_s8(_as(b, ref))
    a_1d, b_1d = a8.ndim == 1, b8.ndim == 1
    if a_1d:
        a8 = a8[None, :]
    if b_1d:
        b8 = b8[:, None]
    az = _zp_arr(azp, ash, ref)  # scalar or 1-D per row of a
    bz = _zp_arr(bzp, bsh, ref)  # scalar or 1-D per column of b
    if az.ndim == 1 and az.shape[0] > 1:
        az = az[:, None]
    out = int8_matmul(a8, b8)
    if not (ash == 0 and bsh == 0 and _zero_static(azp) and _zero_static(bzp)):
        k = a8.shape[-1]
        colsum_b = b8.to(torch.int32).sum(dim=-2, dtype=torch.int32)  # [..., N]
        rowsum_a = a8.to(torch.int32).sum(dim=-1, dtype=torch.int32)  # [..., M]
        out = (out - az * colsum_b[..., None, :]
               - rowsum_a[..., :, None] * bz + k * az * bz)
    if b_1d:
        out = out[..., :, 0]
    if a_1d:
        out = out[..., 0, :] if not b_1d else out[..., 0]
    return out


def _im2col(x8, ks, strides, dils):
    """[N, C, *sp] -> [N, *out_sp, C, *ks] windows (a view)."""
    k = len(ks)
    p = x8
    for d in range(k):
        ke = (ks[d] - 1) * dils[d] + 1
        p = p.unfold(2 + d, ke, strides[d])
        if dils[d] > 1:
            p = p[..., ::dils[d]]
    # p: [N, C, *out_sp, *ks]
    perm = [0] + list(range(2, 2 + k)) + [1] + list(range(2 + k, 2 + 2 * k))
    return p.permute(perm)


def _conv_int(node, x, w, xzp, wzp):
    """Integer ``conv(x - x_zp, w - w_zp)`` -> int32: int8 operands (uint8
    shifts by 128), an im2col and an exact int32 product (cuDNN has no int8
    conv), the zero-point terms from the same windows' sums and per-channel
    constants. Implicit padding pads x with x_zero_point (ONNX spec): the
    shifted input padded with the shifted zero point. Twin of
    ``onnx_jax._conv_int_j``."""
    ref = _live([x, w])
    x, w = _as(x, ref), _as(w, ref)
    k = x.ndim - 2
    if k not in (2, 3):
        raise UnsupportedOnnxOp(f"{node.op_type} over {k}D input")
    strides, pads, dils, groups = _conv_attrs(node, k)
    x8, xsh = _to_s8(x)
    w8, wsh = _to_s8(w)
    xz = _zp_arr(xzp, xsh, ref)
    if xz.numel() != 1:
        raise UnsupportedOnnxOp(f"{node.op_type} per-axis x_zero_point")
    wz = _zp_arr(wzp, wsh, ref)  # scalar or 1-D per output channel
    m, cg = w8.shape[0], w8.shape[1]
    ks = tuple(w8.shape[2:])
    taps = cg * int(np.prod(ks))
    mg = m // groups
    if any(pads):
        x8 = _pad_int8(x8, pads, k, xzp, xsh, xz)
    win = _im2col(x8, ks, strides, dils)  # [N, *out_sp, C, *ks]
    n, out_sp = win.shape[0], tuple(win.shape[1:1 + k])
    rows = win.reshape(-1, groups, taps)  # [L, G, cg * taps]
    wmat = w8.reshape(groups, mg, taps)
    if groups == 1:
        acc = int8_matmul(rows[:, 0], wmat[0].T)  # [L, M]
    elif cg == 1:  # depthwise-like: taps products per channel, int32 sums
        acc = (rows.to(torch.int32)[:, :, None, :] * wmat.to(torch.int32)[None]).sum(
            -1, dtype=torch.int32).reshape(-1, m)
    else:
        acc = torch.cat([int8_matmul(rows[:, g], wmat[g].T) for g in range(groups)], dim=1)
    ch = (1, m) + (1,) * k
    acc = acc.reshape((n,) + out_sp + (m,)).permute(0, k + 1, *range(1, k + 1))
    if not (wsh == 0 and _zero_static(wzp)):
        # - w_zp * window-sum(x): each group's window sums, repeated per
        # output channel of the group
        s = rows.to(torch.int32).sum(-1, dtype=torch.int32)  # [L, G]
        s = s.repeat_interleave(mg, dim=1).reshape((n,) + out_sp + (m,))
        s = s.permute(0, k + 1, *range(1, k + 1))
        acc = acc - wz.reshape(ch if wz.numel() > 1 else ()) * s
    if not (xsh == 0 and _zero_static(xzp)):
        # - x_zp * sum(w) per output channel, + x_zp * w_zp * taps
        wsum = w8.to(torch.int32).sum(dim=tuple(range(1, w8.ndim)),
                                      dtype=torch.int32).reshape(ch)
        acc = acc - xz * wsum
        acc = acc + xz * wz.reshape(ch if wz.numel() > 1 else ()) * taps
    return acc


def _pad_int8(x8, pads, k, xzp, shift, xz: torch.Tensor):
    """Pad the shifted int8 input with the shifted zero point: a static zero
    point pads with its value; a live one replaces the pad positions."""
    if _is_static(xzp):
        value = (0 if xzp is None else int(_scalar(xzp))) - shift
        return F.pad(x8, _pad_arg(pads, k), value=value)
    mask = F.pad(torch.zeros((1, 1) + tuple(x8.shape[2:]), dtype=torch.bool,
                             device=x8.device), _pad_arg(pads, k), value=True)
    return torch.where(mask, xz.reshape(()).to(torch.int8), F.pad(x8, _pad_arg(pads, k)))


def _requant(acc, mul, yzp, qdt, ref):
    """int32 accumulator -> quantized output: saturate(rint(acc * mul) + y_zp)
    in float32 (``onnx_jax._requant_j``)."""
    info = np.iinfo(qdt)
    yz = _as(0 if yzp is None else yzp, ref).to(torch.float32)
    y = torch.round(acc.to(torch.float32) * mul) + yz.reshape(())
    return torch.clamp(y, info.min, info.max).to(_QUANT_DTYPES[np.dtype(qdt)])


def _nms_padded(node, boxes, scores, max_out, iou_thr, score_thr):
    """Static-shape NonMaxSuppression, ``onnx_jax._nms_padded_j``'s
    contract: the PADDED ``[B * C * max_out, 3]`` int64 rows, a pad row
    ``[-1, -1, -1]``; dropping pad rows yields the oracle's rows in its
    (batch, class, score-descending) order, pads at each (batch, class)
    group's tail. The selection loop runs ``min(max_out, boxes)`` sweeps
    over all (batch, class) pairs at once."""
    ref = _live([boxes, scores])
    boxes = _f32(_as(boxes, ref))
    scores = _f32(_as(scores, ref))
    B, nb = boxes.shape[0], boxes.shape[1]
    C = scores.shape[1]
    k = int(min(max_out, nb))
    if k <= 0:  # spec: max_output_boxes_per_class defaults to 0 = no rows
        return torch.zeros((0, 3), dtype=torch.int64, device=boxes.device)
    if C * k > 65536:
        logger.warning(
            "NonMaxSuppression: classes (%d) x max_output_boxes_per_class "
            "(%d) = %d padded rows per image — the static-shape lowering is "
            "a loop over that bound and runs very slowly; re-export with a "
            "realistic max_output_boxes_per_class (e.g. 100-300)", C, k, C * k)
    if int(_attr(node, "center_point_box", 0)):
        half = boxes[..., 2:] * 0.5
        corners = torch.cat([boxes[..., :2] - half, boxes[..., :2] + half], dim=-1)
    else:
        lo = torch.minimum(boxes[..., :2], boxes[..., 2:])
        hi = torch.maximum(boxes[..., :2], boxes[..., 2:])
        corners = torch.cat([lo, hi], dim=-1)
    area = torch.prod(torch.clamp_min(corners[..., 2:] - corners[..., :2], 0.0), dim=-1)
    cor = corners[:, None].expand(B, C, nb, 4)
    ar = area[:, None].expand(B, C, nb)
    alive = torch.ones((B, C, nb), dtype=torch.bool, device=boxes.device) \
        if score_thr is None else scores > score_thr
    ninf = torch.tensor(float("-inf"), device=boxes.device)
    ar_idx = torch.arange(nb, device=boxes.device)
    picks = []
    for _ in range(k):
        masked = torch.where(alive, scores, ninf)
        i = torch.argmax(masked, dim=-1, keepdim=True)  # ties -> lowest index
        ok = torch.gather(masked, -1, i) > ninf
        ci = torch.gather(cor, 2, i[..., None].expand(B, C, 1, 4))  # [B, C, 1, 4]
        lo = torch.maximum(ci[..., :2], cor[..., :2])
        hi = torch.minimum(ci[..., 2:], cor[..., 2:])
        inter = torch.prod(torch.clamp_min(hi - lo, 0.0), dim=-1)
        union = torch.gather(ar, -1, i) + ar - inter
        iou = torch.where(union > 0, inter / torch.clamp_min(union, 1e-12),
                          torch.zeros_like(inter))
        alive = alive & ~(iou > iou_thr) & (ar_idx != i)  # zero-area self guard
        picks.append(torch.where(ok, i, torch.full_like(i, -1)))
    picks = torch.cat(picks, dim=-1)  # [B, C, k]
    valid = picks >= 0
    b_idx = torch.arange(B, device=boxes.device)[:, None, None].expand(B, C, k)
    c_idx = torch.arange(C, device=boxes.device)[None, :, None].expand(B, C, k)
    minus = torch.full_like(picks, -1)
    rows = torch.stack([torch.where(valid, b_idx, minus), torch.where(valid, c_idx, minus),
                        picks], dim=-1)
    return rows.reshape(B * C * k, 3)


# ---------------------------------------------------------------------------
# the lowerings, one per op type: (node, ins) -> output or tuple of outputs
# ---------------------------------------------------------------------------


def _binary(fn):
    def lower(node, ins):
        ref = _live(ins)
        return fn(_as(ins[0], ref), _as(ins[1], ref))
    return lower


def _unary(fn, prep=lambda x: x):
    def lower(node, ins):
        return fn(prep(_live(ins)))
    return lower


def _div(a, b):
    if not a.is_floating_point() and not b.is_floating_point() \
            and a.dtype != torch.bool:
        return torch.div(a, b, rounding_mode="trunc")  # ONNX integer Div truncates
    return a / b


def _gemm(node, ins):
    ref = _live(ins)
    a, b_ = _mxu(_as(ins[0], ref)), _mxu(_as(ins[1], ref))
    if int(_attr(node, "transA", 0)):
        a = a.T
    if int(_attr(node, "transB", 0)):
        b_ = b_.T
    y = float(_attr(node, "alpha", 1.0)) * torch.matmul(a, b_)
    if _opt(ins, 2) is not None:
        y = y + float(_attr(node, "beta", 1.0)) * _as(ins[2], ref).to(y.dtype)
    return y


def _batchnorm(node, ins):
    ref = _live(ins)
    x, scale, bias, mean, var = (_acc(_as(v, ref)) for v in ins[:5])
    eps = float(_attr(node, "epsilon", 1e-5))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return ((x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
            * scale.reshape(shape) + bias.reshape(shape))


def _clip(node, ins):
    x = _as(ins[0], _live(ins))
    lo, hi = _opt(ins, 1), _opt(ins, 2)
    lo = _attr(node, "min", lo)
    hi = _attr(node, "max", hi)

    def bound(v):
        if v is None or isinstance(v, torch.Tensor):
            return v
        return _scalar(v)

    lo, hi = bound(lo), bound(hi)
    if lo is None and hi is None:
        return x
    if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
        lo = lo if lo is None or isinstance(lo, torch.Tensor) else torch.tensor(lo, device=x.device)
        hi = hi if hi is None or isinstance(hi, torch.Tensor) else torch.tensor(hi, device=x.device)
    return torch.clamp(x, lo, hi)


def _concat(node, ins):
    ref = _live(ins)
    return torch.cat([_as(v, ref) for v in ins], dim=int(_attr(node, "axis")))


def _where(node, ins):
    ref = _live(ins)
    return torch.where(_as(ins[0], ref).bool(), _as(ins[1], ref), _as(ins[2], ref))


def _cast(node, ins):
    to = int(_attr(node, "to"))
    if to not in _CAST_DTYPES:
        raise UnsupportedOnnxOp(f"Cast to TensorProto dtype code {to}")
    return _live(ins).to(_CAST_DTYPES[to])


def _instance_norm(node, ins):
    ref = _live(ins)
    x, scale, bias = (_f32(_as(v, ref)) for v in ins[:3])
    eps = float(_attr(node, "epsilon", 1e-5))
    sp = tuple(range(2, x.ndim))
    mean = x.mean(dim=sp, keepdim=True)
    var = x.var(dim=sp, keepdim=True, correction=0)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return (x - mean) / torch.sqrt(var + eps) * scale.reshape(shape) + bias.reshape(shape)


def _group_norm(node, ins):
    ref = _live(ins)
    x, scale, bias = (_f32(_as(v, ref)) for v in ins[:3])
    eps = float(_attr(node, "epsilon", 1e-5))
    ng = int(_attr(node, "num_groups"))
    n, c = x.shape[:2]
    xg = x.reshape((n, ng, c // ng) + tuple(x.shape[2:]))
    red = tuple(range(2, xg.ndim))
    mean = xg.mean(dim=red, keepdim=True)
    var = xg.var(dim=red, keepdim=True, correction=0)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return y * scale.reshape(shape) + bias.reshape(shape)


def _layer_norm(node, ins):
    ref = _live(ins)
    x = _f32(_as(ins[0], ref))
    scale = _f32(_as(ins[1], ref))
    bias = _f32(_as(ins[2], ref)) if _opt(ins, 2) is not None else None
    eps = float(_attr(node, "epsilon", 1e-5))
    axis = int(_attr(node, "axis", -1)) % x.ndim
    red = tuple(range(axis, x.ndim))
    mean = x.mean(dim=red, keepdim=True)
    inv = 1.0 / torch.sqrt(x.var(dim=red, keepdim=True, correction=0) + eps)
    y = (x - mean) * inv * scale
    if bias is not None:
        y = y + bias
    return y, mean, inv


def _gelu(node, ins):
    x = _mxu(_live(ins))
    if _attr(node, "approximate", "none") == "tanh":
        return 0.5 * x * (1.0 + torch.tanh(float(np.sqrt(2.0 / np.pi))
                                           * (x + 0.044715 * x ** 3)))
    return 0.5 * x * (1.0 + torch.erf(x / float(np.sqrt(2.0))))


def _softplus(x):
    """``logaddexp(0, x)`` as XLA expands it: max + log1p(exp(-|delta|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _arg(node, ins):
    if int(_attr(node, "select_last_index", 0)):
        raise UnsupportedOnnxOp(f"{node.op_type} select_last_index")
    x = _live(ins)
    axis = int(_attr(node, "axis", 0))
    keep = bool(int(_attr(node, "keepdims", 1)))
    fn = torch.argmax if node.op_type == "ArgMax" else torch.argmin
    return fn(x, dim=axis, keepdim=keep).to(torch.int64)


def _depth_to_space(node, ins):
    bs = int(_attr(node, "blocksize"))
    x = _live(ins)
    n, c, h, w = x.shape
    if _attr(node, "mode", "DCR") == "DCR":
        y = x.reshape(n, bs, bs, c // (bs * bs), h, w).permute(0, 3, 4, 1, 5, 2)
    else:  # CRD (torch PixelShuffle)
        y = x.reshape(n, c // (bs * bs), bs, bs, h, w).permute(0, 1, 4, 2, 5, 3)
    return y.reshape(n, c // (bs * bs), h * bs, w * bs)


def _space_to_depth(node, ins):
    bs = int(_attr(node, "blocksize"))
    x = _live(ins)
    n, c, h, w = x.shape
    y = x.reshape(n, c, h // bs, bs, w // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * bs * bs, h // bs, w // bs)


def _trilu(node, ins):
    k = int(np.asarray(_need_static("Trilu", ins[1], "diagonal offset")).item()) \
        if _opt(ins, 1) is not None else 0
    fn = torch.triu if int(_attr(node, "upper", 1)) else torch.tril
    return fn(_live(ins), k)


def _gather_elements(node, ins):
    ref = _live(ins)
    x, idx = _as(ins[0], ref), _as(ins[1], ref).long()
    axis = int(_attr(node, "axis", 0)) % x.ndim
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    return torch.gather(x, axis, idx)


def _quantize_linear(node, ins):
    x = _f32(_live(ins))
    zp = _opt(ins, 2)
    qdt = _qdt(zp)
    s, z = _quant_axis(x.ndim, ins[1], zp, int(_attr(node, "axis", 1)), x)
    info = np.iinfo(qdt)
    y = torch.round(x / s) + z.to(torch.float32)
    return torch.clamp(y, info.min, info.max).to(_QUANT_DTYPES[qdt])


def _dequantize_linear(node, ins):
    ref = _live(ins)
    x = _as(ins[0], ref)
    zp = _opt(ins, 2)
    s, z = _quant_axis(x.ndim, ins[1], zp, int(_attr(node, "axis", 1)), ref)
    return (x.to(torch.int32) - z).to(torch.float32) * s


def _dynamic_quantize_linear(node, ins):
    x = _f32(_live(ins))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    xmin = torch.minimum(x.min(), zero)  # spec: the range always includes 0
    xmax = torch.maximum(x.max(), zero)
    rng = xmax - xmin
    # an explicit reciprocal multiply, as the numpy twin
    scale = torch.where(rng > 0, rng * float(np.float32(1.0 / 255.0)), zero + 1.0)
    zp_f = torch.clamp(torch.round(-xmin / scale), 0, 255)
    y = torch.clamp(torch.round(x / scale) + zp_f, 0, 255).to(torch.uint8)
    return y, scale.to(torch.float32), zp_f.to(torch.uint8)


def _matmul_integer(node, ins):
    return _matmul_int(ins[0], ins[1], _opt(ins, 2), _opt(ins, 3))


def _conv_integer(node, ins):
    return _conv_int(node, ins[0], ins[1], _opt(ins, 2), _opt(ins, 3))


def _qlinear_conv(node, ins):
    x, x_s, x_zp, w, w_s, w_zp, y_s, y_zp = ins[:8]
    ref = _live(ins)
    acc = _conv_int(node, x, w, x_zp, w_zp)
    b = _opt(ins, 8)
    if b is not None:
        acc = acc + _as(b, ref).to(torch.int32).reshape((1, -1) + (1,) * (acc.ndim - 2))
    wsc = _as(w_s, ref).to(torch.float32)
    if wsc.ndim == 1 and wsc.shape[0] > 1:  # per output channel
        wsc = wsc.reshape((1, -1) + (1,) * (acc.ndim - 2))
    mul = (_as(x_s, ref).to(torch.float32).reshape(()) * wsc
           / _as(y_s, ref).to(torch.float32).reshape(()))
    return _requant(acc, mul, y_zp, _qdt(y_zp), ref)


def _qlinear_matmul(node, ins):
    a, a_s, a_zp, b, b_s, b_zp, y_s, y_zp = ins[:8]
    ref = _live(ins)
    acc = _matmul_int(a, b, a_zp, b_zp)
    mul = (_as(a_s, ref).to(torch.float32).reshape(())
           * _as(b_s, ref).to(torch.float32).reshape(())
           / _as(y_s, ref).to(torch.float32).reshape(()))
    return _requant(acc, mul, y_zp, _qdt(y_zp), ref)


def _non_max_suppression(node, ins):
    ref = _live(ins)
    max_out = int(np.asarray(_need_static(
        "NonMaxSuppression", ins[2], "max_output_boxes_per_class")).item()) \
        if _opt(ins, 2) is not None else 0
    iou_thr = _opt(ins, 3)
    score_thr = _opt(ins, 4)
    iou_thr = _as(0.0 if iou_thr is None else iou_thr, ref).to(torch.float32).reshape(())
    if score_thr is not None:
        score_thr = _as(score_thr, ref).to(torch.float32).reshape(())
    return _nms_padded(node, ins[0], ins[1], max_out, iou_thr, score_thr)


def _scatter_nd(node, ins):
    ref = _live(ins)
    data = _as(ins[0], ref)
    indices = _as(ins[1], ref).long()
    updates = _as(ins[2], ref).to(data.dtype)
    reduction = _attr(node, "reduction", "none") or "none"
    r = indices.shape[-1]
    lead = data.shape[:r]
    idx = indices.reshape(-1, r)
    lin = torch.zeros(idx.shape[0], dtype=torch.int64, device=data.device)
    for d in range(r):
        lin = lin * lead[d] + torch.where(idx[:, d] < 0, idx[:, d] + lead[d], idx[:, d])
    flat = data.reshape((-1,) + tuple(data.shape[r:]))
    upd = updates.reshape((-1,) + tuple(data.shape[r:]))
    if reduction == "none":
        out = flat.index_put((lin,), upd)
    elif reduction == "add":
        out = flat.index_add(0, lin, upd)
    else:
        idx_full = lin.reshape((-1,) + (1,) * (upd.ndim - 1)).expand_as(upd)
        out = flat.scatter_reduce(0, idx_full, upd, {"mul": "prod", "min": "amin",
                                                     "max": "amax"}[reduction])
    return out.reshape(data.shape)


def _constant_of_shape(node, ins):
    # shape machinery: must fold (only reached when a live tensor leaked
    # into the shape, which raises)
    shape = _ints(_need_static("ConstantOfShape", ins[0], "shape"))
    v = _attr(node, "value")
    fill = v.reshape(-1)[0] if v is not None else np.float32(0)
    return np.full(shape, fill)


def _range(node, ins):
    s, l_, d = (np.asarray(_need_static("Range", v, "Range bounds")) for v in ins[:3])
    return np.arange(s.item(), l_.item(), d.item(), dtype=np.result_type(s, l_, d))


def _mod(node, ins):
    ref = _live(ins)
    a, b_ = _as(ins[0], ref), _as(ins[1], ref)
    return torch.fmod(a, b_) if int(_attr(node, "fmod", 0)) else torch.remainder(a, b_)


def _prelu(node, ins):
    ref = _live(ins)
    x, slope = _as(ins[0], ref), _as(ins[1], ref)
    return torch.where(x < 0, slope * x, x)


def _leaky_relu(node, ins):
    x = _live(ins)
    alpha = float(_attr(node, "alpha", 0.01))
    return torch.where(x > 0, x, alpha * x)


def _elu(node, ins):
    alpha = float(_attr(node, "alpha", 1.0))
    x = _mxu(_live(ins))
    return torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))


def _selu(node, ins):
    alpha = float(_attr(node, "alpha", 1.6732631921768188))
    gamma = float(_attr(node, "gamma", 1.0507009873554805))
    x = _mxu(_live(ins))
    return gamma * torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))


def _celu(node, ins):
    alpha = float(_attr(node, "alpha", 1.0))
    x = _mxu(_live(ins))
    return torch.clamp_min(x, 0) + torch.clamp_max(alpha * (torch.exp(x / alpha) - 1.0), 0)


def _hard_sigmoid(node, ins):
    alpha = float(_attr(node, "alpha", 0.2))
    beta = float(_attr(node, "beta", 0.5))
    return torch.clamp(alpha * _mxu(_live(ins)) + beta, 0.0, 1.0)


def _hard_swish(node, ins):
    x = _mxu(_live(ins))
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def _einsum(node, ins):
    ref = _live(ins)
    return torch.einsum(_attr(node, "equation"), *[_mxu(_as(v, ref)) for v in ins])


def _softmax_like(fn):
    def lower(node, ins):
        return fn(_f32(_live(ins)), dim=int(_attr(node, "axis", -1)))
    return lower


def _expand(node, ins):
    shape = tuple(_ints(_need_static("Expand", ins[1], "target shape")))
    x = _live(ins)
    return torch.broadcast_to(x, np.broadcast_shapes(tuple(x.shape), shape))


def _flatten(node, ins):
    ax = int(_attr(node, "axis", 1))
    x = _live(ins)
    return x.reshape(int(np.prod(x.shape[:ax], initial=1)), -1)


def _transpose(node, ins):
    x = _live(ins)
    perm = _attr(node, "perm")
    return x.permute(*(perm if perm is not None else reversed(range(x.ndim))))


def _tile(node, ins):
    return torch.tile(_live(ins), tuple(_ints(_need_static("Tile", ins[1], "repeats"))))


def _lstm(node, ins):
    return _rnn_scan(node, ins, "LSTM")


def _gru(node, ins):
    return _rnn_scan(node, ins, "GRU")


_LOWER: Dict[str, Callable] = {
    "Conv": _conv,
    "Gemm": _gemm,
    "MatMul": lambda node, ins: torch.matmul(*(_mxu(_as(v, _live(ins))) for v in ins[:2])),
    "BatchNormalization": _batchnorm,
    "Relu": lambda node, ins: torch.clamp_min(_live(ins), 0),
    "LeakyRelu": _leaky_relu,
    "Sigmoid": _unary(torch.sigmoid, _mxu),
    "Tanh": _unary(torch.tanh, _mxu),
    "Softmax": _softmax_like(torch.softmax),
    "LogSoftmax": _softmax_like(torch.log_softmax),
    "Exp": _unary(torch.exp, _mxu),
    "Sqrt": _unary(torch.sqrt, _mxu),
    "Pow": lambda node, ins: torch.pow(_f32(_as(ins[0], _live(ins))), _as(ins[1], _live(ins))),
    "Neg": _unary(torch.neg),
    "Erf": _unary(torch.erf, _mxu),
    "Clip": _clip,
    "Add": _binary(torch.add),
    "Sub": _binary(torch.sub),
    "Mul": _binary(torch.mul),
    "Div": _binary(_div),
    "Max": _binary(torch.maximum),
    "Min": _binary(torch.minimum),
    "MaxPool": lambda node, ins: _pool(node, ins, "max"),
    "AveragePool": lambda node, ins: _pool(node, ins, "avg"),
    "GlobalAveragePool": lambda node, ins: (lambda x: x.mean(
        dim=tuple(range(2, x.ndim)), keepdim=True))(_acc(_live(ins))),
    "GlobalMaxPool": lambda node, ins: (lambda x: torch.amax(
        x, dim=tuple(range(2, x.ndim)), keepdim=True))(_live(ins)),
    "Concat": _concat,
    "Split": _split,
    "Slice": _slice,
    "Reshape": _reshape,
    "Transpose": _transpose,
    "Flatten": _flatten,
    "Squeeze": _squeeze,
    "Unsqueeze": _unsqueeze,
    "Expand": _expand,
    "Tile": _tile,
    "Gather": _gather,
    "Cast": _cast,
    "Resize": _resize,
    "ReduceMean": lambda node, ins: _reduce(node, ins, "mean"),
    "ReduceSum": lambda node, ins: _reduce(node, ins, "sum"),
    "ReduceMax": lambda node, ins: _reduce(node, ins, "max"),
    "ReduceMin": lambda node, ins: _reduce(node, ins, "min"),
    "ReduceProd": lambda node, ins: _reduce(node, ins, "prod"),
    "ReduceL2": lambda node, ins: _reduce(node, ins, "l2"),
    "Identity": lambda node, ins: ins[0],
    "Dropout": lambda node, ins: ins[0],
    "Where": _where,
    "Equal": _binary(torch.eq),
    "LSTM": _lstm,
    "GRU": _gru,
    "ConvTranspose": _conv_transpose,
    "InstanceNormalization": _instance_norm,
    "GroupNormalization": _group_norm,
    "LayerNormalization": _layer_norm,
    "HardSigmoid": _hard_sigmoid,
    "HardSwish": _hard_swish,
    "Elu": _elu,
    "Softplus": _unary(_softplus, _mxu),
    "PRelu": _prelu,
    "Gelu": _gelu,
    "Mish": _unary(lambda x: x * torch.tanh(_softplus(x)), _mxu),
    "Abs": _unary(torch.abs),
    "Floor": _unary(torch.floor),
    "Ceil": _unary(torch.ceil),
    "Round": _unary(torch.round),  # half to even, as ONNX
    "Sign": _unary(torch.sign),
    "Not": _unary(torch.logical_not),
    "Log": _unary(torch.log, _mxu),
    "Sin": _unary(torch.sin, _mxu),
    "Cos": _unary(torch.cos, _mxu),
    "Reciprocal": _unary(lambda v: 1.0 / v, _mxu),
    "Greater": _binary(torch.gt),
    "Less": _binary(torch.lt),
    "GreaterOrEqual": _binary(torch.ge),
    "LessOrEqual": _binary(torch.le),
    "And": _binary(torch.logical_and),
    "Or": _binary(torch.logical_or),
    "Xor": _binary(torch.logical_xor),
    "Mod": _mod,
    "ArgMax": _arg,
    "ArgMin": _arg,
    "CumSum": _cumsum,
    "Pad": _pad,
    "DepthToSpace": _depth_to_space,
    "SpaceToDepth": _space_to_depth,
    "Einsum": _einsum,
    "Trilu": _trilu,
    "TopK": _topk,
    "GatherElements": _gather_elements,
    "Selu": _selu,
    "Celu": _celu,
    "QuantizeLinear": _quantize_linear,
    "DequantizeLinear": _dequantize_linear,
    "DynamicQuantizeLinear": _dynamic_quantize_linear,
    "MatMulInteger": _matmul_integer,
    "ConvInteger": _conv_integer,
    "QLinearConv": _qlinear_conv,
    "QLinearMatMul": _qlinear_matmul,
    "NonMaxSuppression": _non_max_suppression,
    "ScatterND": _scatter_nd,
    "ConstantOfShape": _constant_of_shape,
    "Range": _range,
}


def _lowering(node: OnnxNode) -> Callable:
    fn = _LOWER.get(node.op_type)
    if fn is None:
        raise UnsupportedOnnxOp(
            f"op '{node.op_type}' (node '{node.name}') is outside the supported set")
    return fn


def _exec(fn, node: OnnxNode, values: Dict[str, object], cd) -> None:
    """Run one live node and store its outputs ("" = an omitted optional
    output: never clobber the values[""] = None absent-input sentinel);
    under the bf16 policy every live float output returns to bf16."""
    res = fn(node, [values[i] for i in node.inputs])
    if not isinstance(res, tuple):
        res = (res,)
    for name, r in zip(node.outputs, res):
        if name:
            if cd is not None and isinstance(r, torch.Tensor) \
                    and r.is_floating_point() and r.dtype != cd:
                r = r.to(cd)
            values[name] = r


def _shape_of(node: OnnxNode, v) -> np.ndarray:
    """``Shape`` of a live tensor: its concrete shape (opset-15 start/end)."""
    shp = np.asarray(tuple(v.shape) if isinstance(v, torch.Tensor) else np.shape(v),
                     dtype=np.int64)
    start, end = node.attrs.get("start"), node.attrs.get("end")
    if start is not None or end is not None:
        shp = shp[slice(int(start) if start is not None else None,
                        int(end) if end is not None else None)]
    return shp


def _run(g: OnnxGraph, feeds: Dict[str, object],
         outputs: Optional[Sequence[str]] = None,
         steps: Optional[list] = None) -> Tuple[List[object], Dict[str, object]]:
    """Fold-or-lower evaluation (``onnx_jax._run``). With ``steps`` (a
    list) every live node is appended to it with its lowering, in
    execution order. Returns the outputs and the final value table."""
    values: Dict[str, object] = {"": None}
    values.update(g.initializers)
    values.update(feeds)
    missing = [i for i in g.inputs if i not in values]
    if missing:
        raise ValueError(f"missing graph inputs: {missing}")
    cd = _COMPUTE.get()
    pending: List[OnnxNode] = list(g.nodes)
    while pending:
        progressed = False
        deferred: List[OnnxNode] = []
        for node in pending:
            if any(i and i not in values for i in node.inputs):
                deferred.append(node)
                continue
            ins = [values[i] for i in node.inputs]
            if node.op_type == "Shape":
                if node.outputs[0]:
                    values[node.outputs[0]] = _shape_of(node, ins[0])
            elif all(_is_static(v) for v in ins):
                _eval_node(node, values)
            else:
                fn = _lowering(node)
                _exec(fn, node, values, cd)
                if steps is not None:
                    steps.append((fn, node))
            progressed = True
        if not progressed:
            blocked = [n.op_type for n in deferred[:5]]
            raise ValueError(
                f"graph is not schedulable (cycle or missing producer); blocked at {blocked}")
        pending = deferred
    out_names = list(outputs) if outputs is not None else g.outputs
    missing = [o for o in out_names if o not in values]
    if missing:
        raise ValueError(f"graph did not produce outputs: {missing}")
    return [values[o] for o in out_names], values


def _live_feeds(feeds: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """Every feed is live (a traced argument under ``jax.jit``)."""
    return {k: v if isinstance(v, torch.Tensor) else to_torch(v) for k, v in feeds.items()}


class _Plan:
    """One input key's plan: the numpy constants the live nodes and the
    outputs read, the live nodes in order, and the constant cache."""

    __slots__ = ("constants", "steps", "cache")

    def __init__(self, constants, steps, cache):
        self.constants, self.steps, self.cache = constants, steps, cache


class CompiledGraph:
    """``fn(feeds) -> [outputs]``, planned once per input key (module
    docstring). ``unplanned(feeds)`` runs the interpreter every time."""

    def __init__(self, g: OnnxGraph, outputs: Optional[Sequence[str]] = None):
        self.graph = g
        self.outputs = list(outputs) if outputs is not None else list(g.outputs)
        self._plans: Dict[tuple, _Plan] = {}

    @staticmethod
    def _key(feeds: Dict[str, torch.Tensor]) -> tuple:
        return (_COMPUTE.get(),) + tuple(sorted(
            (k, tuple(v.shape), v.dtype, str(v.device)) for k, v in feeds.items()))

    def unplanned(self, feeds: Dict[str, object]) -> List[object]:
        return _run(self.graph, _live_feeds(feeds), self.outputs)[0]

    @contextlib.contextmanager
    def scratch_plans(self) -> Iterator[None]:
        """Plans made inside are dropped at the end, and none made before
        is used: a trace (``engine/export.py``) runs on stand-in tensors,
        whose device copies of the constants must not serve a live call."""
        kept, self._plans = self._plans, {}
        try:
            yield
        finally:
            self._plans = kept

    def plan_for(self, feeds: Dict[str, object]) -> Optional[_Plan]:
        """The plan of these feeds' key, if one was made."""
        return self._plans.get(self._key(_live_feeds(feeds)))

    def __call__(self, feeds: Dict[str, object]) -> List[object]:
        feeds = _live_feeds(feeds)
        key = self._key(feeds)
        plan = self._plans.get(key)
        if plan is None:
            cache: dict = {}
            steps: list = []
            tok = _CACHE.set(cache)
            try:
                outs, values = _run(self.graph, feeds, self.outputs, steps)
            finally:
                _CACHE.reset(tok)
            produced = {o for _, n in steps for o in n.outputs}
            read = {i for _, n in steps for i in n.inputs} | set(self.outputs)
            constants = {n: values[n] for n in read
                         if n and n not in feeds and n not in produced}
            constants[""] = None
            self._plans[key] = _Plan(constants, steps, cache)
            return outs
        values = dict(plan.constants)
        values.update(feeds)
        cd = _COMPUTE.get()
        tok = _CACHE.set(plan.cache)
        try:
            for fn, node in plan.steps:
                _exec(fn, node, values, cd)
        finally:
            _CACHE.reset(tok)
        return [values[o] for o in self.outputs]


def compile_graph(g: OnnxGraph, outputs: Optional[Sequence[str]] = None) -> CompiledGraph:
    """``fn(feeds) -> [outputs]``; ``feeds`` maps graph input names (and
    runtime params) to tensors. Plans once per input key."""
    return CompiledGraph(g, outputs)
