"""Device meshes, sharding rules and the sharded forward, in one process.

Counterpart of ``realtime_analytics_tpu/parallel/mesh.py``. The JAX engine
is single-controller: one process drives every device of its mesh, and
GSPMD partitions each step. The port's mesh is the same in one process: an
array of ``torch.device``s with named axes, (dp, tp) or (dp, sp, tp),
driven by one controller, with no ``torch.distributed`` (a process group
would change how the engine and the batcher are built).

Sharding policy for the YOLO / ResNet / temporal params (JAX's rule,
``_leaf_spec``, on the JAX-layout tree: channels last):

  * conv kernels  [kh, kw, cin, cout] -> cout over tp when tp divides it,
    else replicated;
  * dense kernels [cin, cout]         -> cout over tp when divisible;
  * biases        [cout]              -> over tp when divisible;
  * the v5 ``anchors`` buffer and scalars -> replicated;
  * activations                       -> batch over dp, and on a mesh
    with an sp axis image height over sp (JAX's ``P("dp", "sp", None,
    None)`` for the train step's images).

A tp-sharded weight is one output-channel slice per tp rank, on that rank's
device; a dp-sharded batch is one chunk per dp row. ``ShardedModel`` runs a
model's forward with GSPMD's semantics: each dp row runs its chunk, a conv
or dense whose weight is tp-sharded computes each rank's output-channel
slice on that rank (``TpSplit``), and the slices are joined on the row's
first device (the all-gather XLA inserts) before the next op, which needs
every channel: the next conv's input, C2f's split, a concat, SPPF, the
head. A module that reads such a weight instead of calling it (the v5
head, the temporal ConvGRU's gates) reads the joined weight; modules
without an output-channel form (the LSTM) keep replicated weights.
``dp_map`` is ``jax.shard_map`` over dp: the kernels B1, B4 and B6 run once
per dp shard on that shard's rows (``ops/gather.py``, ``ops/letterbox.py``,
``ops/nms.py``).

The sp axis (``parallel/spatial.py``): each dp row's images split by height
over the row's sp ranks, and a YOLO forward runs every conv, pool,
upsample and concat on the bands, fetching the rows each op's outputs need
from the ranks that hold them (GSPMD's halo exchanges, its
collective-permutes); rank (r, s) runs its tp slices on ``devices[r, s, :]``.

A device may appear more than once in a mesh: ``[cpu] * 8`` is the
counterpart of XLA's virtual host devices (the tests' 8-device CPU mesh),
``[cuda:0] * k`` lays a k-entry mesh on one card.
"""

from __future__ import annotations

import copy
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.layers import ConvAct, Dense
from ..models.temporal import Conv3d

AXES = ("dp", "tp")
AXES_SP = ("dp", "sp", "tp")  # the three-axis form: sp splits image height


class Mesh:
    """Named axes over an array of devices: ``devices[r, t]`` is dp row r,
    tp rank t (``devices[r, s, t]`` on a (dp, sp, tp) mesh). ``shape`` maps
    each axis name to its size, in order; ``grid`` is the devices as
    [dp, sp, tp] whatever the axes (sp 1 on a two-axis mesh)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))
        self.grid = devices.reshape(self.shape["dp"], self.shape.get("sp", 1),
                                    self.shape["tp"])

    def lead(self, r: int) -> torch.device:
        """Dp row r's first device: where its shard of a batch lives."""
        return self.grid[r, 0, 0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(
    n_devices: Optional[int] = None,
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = AXES,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A (dp, tp) mesh over ``n_devices`` devices, JAX's default shape
    (8 -> dp 4, tp 2), or with ``axis_names=AXES_SP`` a (dp, sp, tp) one
    (8 -> 2, 2, 2). ``devices=None`` takes the visible cards
    ``cuda:0..n-1`` and raises when fewer are visible; an explicit list may
    name one device more than once."""
    if devices is None:
        visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        n = n_devices or len(visible)
        if n < 1 or len(visible) < n:
            raise ValueError(
                f"requested a {n}-device mesh but {len(visible)} CUDA card(s) are "
                "visible. To lay the mesh on fewer devices, name them: "
                f"make_mesh({n}, devices=[torch.device('cpu')] * {n}) for a virtual "
                f"mesh on the CPU (an engine with device: cpu builds its mesh so), or "
                f"devices=[torch.device('cuda', 0)] * {n} for every entry on one card")
    else:
        visible = [torch.device(d) for d in devices]
        n = n_devices or len(visible)
        if n < 1 or len(visible) < n:
            raise ValueError(f"requested a {n}-device mesh but devices= names "
                             f"{len(visible)}")
    if shape is None:
        sizes, rem = [], n
        for _ in range(len(axis_names) - 1, 0, -1):
            f = 2 if rem % 2 == 0 and rem >= 2 else 1
            sizes.append(f)
            rem //= f
        shape = (rem, *reversed(sizes))
    shape = tuple(int(v) for v in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != device count {n}")
    if tuple(axis_names) not in (AXES, AXES_SP) or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} must name the axes {AXES} or {AXES_SP} "
                         f"(got {tuple(axis_names)})")
    arr = np.empty(n, dtype=object)
    arr[:] = visible[:n]
    return Mesh(arr.reshape(shape), axis_names)


class NamedSharding(NamedTuple):
    """A leaf's layout over a mesh: ``spec`` names, per dimension, the
    mesh axis it is split over (None: whole); ``()`` is replicated."""

    mesh: Mesh
    spec: Tuple


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def batch_sharding(mesh: Mesh, ndim: int, axis: int = 0) -> NamedSharding:
    spec = [None] * ndim
    spec[axis] = "dp"
    return NamedSharding(mesh, tuple(spec))


def _leaf_spec(leaf, tp_size: int, path: str = "") -> Tuple:
    """Channel-shard weight-like leaves over tp; replicate the rest (JAX's
    rule). ``leaf``: an array, or its JAX-layout shape. 'Weight-like' =
    channel dim last: conv [kh,kw,cin,cout], dense [cin,cout], int8 w_q,
    1-D per-channel biases and scales. The v5 'anchors' buffer [3,3,2] is
    excluded by path: its last dim is a (w,h) pair, not channels."""
    shape = tuple(getattr(leaf, "shape", leaf))
    if len(shape) == 0 or "anchors" in path:
        return ()
    cout = shape[-1]
    if tp_size > 1 and cout % tp_size == 0 and cout >= tp_size:
        return (*([None] * (len(shape) - 1)), "tp")
    return ()


def _tree_map(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists; ``path`` as JAX's
    ``keystr`` writes it (``['layers']['22']['anchors']``)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, f"{path}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, f"{path}[{i}]") for i, v in enumerate(tree))
    return fn(path, tree)


def param_shardings(params, mesh: Mesh):
    """NamedSharding tree for a params tree (channel-sharded over tp)."""
    tp = mesh.shape.get("tp", 1)
    return _tree_map(lambda path, leaf: NamedSharding(mesh, _leaf_spec(leaf, tp, path)),
                     params)


class Sharded(NamedTuple):
    """A leaf placed on a mesh: ``pieces[r, t]`` (``pieces[r, s, t]``) is
    what that device holds (its tp slice, or the whole leaf when
    replicated)."""

    spec: Tuple
    pieces: np.ndarray

    def full(self) -> torch.Tensor:
        """The whole leaf, joined from the first tp row on its first device."""
        row = self.pieces.reshape(-1, self.pieces.shape[-1])[0]
        if "tp" not in self.spec:
            return row[0]
        dim = self.spec.index("tp")
        return torch.cat([p.to(row[0].device) for p in row], dim=dim)


def shard_params(params, mesh: Mesh):
    """Place a params tree (numpy or tensors) on the mesh with channel
    sharding: a tree of ``Sharded`` leaves."""
    tp = mesh.shape.get("tp", 1)

    def place(path, leaf):
        spec = _leaf_spec(leaf, tp, path)
        whole = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
        cache: Dict[Tuple[str, int], torch.Tensor] = {}  # one copy a (device, slice)
        pieces = np.empty(mesh.devices.shape, dtype=object)
        for idx, dev in np.ndenumerate(mesh.devices):
            rank = idx[-1] if spec else 0
            if (str(dev), rank) not in cache:
                part = whole.chunk(tp, dim=whole.dim() - 1)[rank] if spec else whole
                cache[(str(dev), rank)] = part.to(dev).contiguous()
            pieces[idx] = cache[(str(dev), rank)]
        return Sharded(spec, pieces)

    return _tree_map(place, params)


# ---------------------------------------------------------------------------
# the sharded forward
# ---------------------------------------------------------------------------

_SPLITTABLE = (ConvAct, Conv3d, Dense)


def _jax_shape(mod: nn.Module) -> Tuple[int, ...]:
    """The JAX-layout shape of a splittable module's weight (channels
    last): ``_leaf_spec`` decides on it."""
    w = mod.weight
    return (*w.shape[2:], w.shape[1], w.shape[0]) if w.dim() > 2 else (w.shape[1], w.shape[0])


def _splits(mod: nn.Module, tp: int) -> bool:
    return (tp > 1 and isinstance(mod, _SPLITTABLE) and getattr(mod, "w_q", None) is None
            and bool(_leaf_spec(_jax_shape(mod), tp)))


def _slice_module(mod: nn.Module, sl: slice, dev: torch.device) -> nn.Module:
    """A copy of ``mod`` holding output channels ``sl`` of its weight, bias
    and per-channel buffers (the fused neck's halves), on ``dev``."""
    part = copy.copy(mod)
    fmt = (torch.channels_last if mod.weight.dim() == 4 else
           torch.channels_last_3d if mod.weight.dim() == 5 else torch.contiguous_format)
    part._parameters = {
        k: None if p is None else nn.Parameter(
            p.detach()[sl].to(dev).contiguous(
                memory_format=fmt if p.dim() == mod.weight.dim() else torch.contiguous_format),
            requires_grad=p.requires_grad)
        for k, p in mod._parameters.items()}
    part._buffers = {k: None if b is None else b[sl].to(dev).contiguous(memory_format=fmt)
                     for k, b in mod._buffers.items()}
    if isinstance(mod, ConvAct):
        part.shape = (sl.stop - sl.start, *mod.shape[1:])
    return part


class TpSplit(nn.Module):
    """A conv or dense whose output channels are split over tp: part t
    holds rank t's slice on that rank's device, computes it there, and the
    slices are joined on the input's device (the all-gather). Reading
    ``weight``, ``bias`` or ``plain_weight`` gives the joined tensor."""

    def __init__(self, mod: nn.Module, devices: Sequence[torch.device]):
        super().__init__()
        step = mod.weight.shape[0] // len(devices)
        self.step = step
        self.dim = -1 if isinstance(mod, Dense) else 1
        self.parts = nn.ModuleList(
            _slice_module(mod, slice(t * step, (t + 1) * step), dev)
            for t, dev in enumerate(devices))

    def _join(self, ys: List[torch.Tensor], dev: torch.device, dim: int) -> torch.Tensor:
        return torch.cat([y.to(dev) for y in ys], dim=dim)

    def forward(self, x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``weight``: a whole override weight (the engine's folded stem),
        sliced here per rank; ``residual``: a conv's shortcut (``ConvAct``),
        its channels sliced per rank as the output's."""
        ys = []
        for t, part in enumerate(self.parts):
            dev = part.bias.device
            sl = slice(t * self.step, (t + 1) * self.step)
            args = [x.to(dev)] if weight is None else [x.to(dev), weight[sl].to(dev)]
            if residual is None:
                ys.append(part(*args))
            else:
                ys.append(part(*args, residual=residual[:, sl].to(dev)))
        return self._join(ys, x.device, self.dim)

    def up_concat(self, x_small: torch.Tensor, y_skip: torch.Tensor) -> torch.Tensor:
        """The fused neck's split 1x1 (``ConvAct.up_concat``), per rank."""
        ys = [part.up_concat(x_small.to(part.bias.device), y_skip.to(part.bias.device))
              for part in self.parts]
        return self._join(ys, x_small.device, 1)

    @property
    def weight(self) -> torch.Tensor:
        return self._join([p.weight for p in self.parts], self.parts[0].weight.device, 0)

    @property
    def bias(self) -> torch.Tensor:
        return self._join([p.bias for p in self.parts], self.parts[0].bias.device, 0)

    def plain_weight(self, dtype: torch.dtype) -> torch.Tensor:
        return self._join([p.plain_weight(dtype) for p in self.parts],
                          self.parts[0].bias.device, 0)


def _join_outputs(outs: List, dev: torch.device):
    """Per-row outputs (tensors, or dicts / tuples of them) joined along
    the batch on ``dev``."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _join_outputs([o[k] for o in outs], dev) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_join_outputs([o[i] for o in outs], dev) for i in range(len(first)))
    return torch.cat([o.to(dev) for o in outs], dim=0)


def dp_map(fn, mesh: Mesh, *args: torch.Tensor):
    """``fn`` over each dp shard of the batch-leading tensors ``args`` (row
    r's shard on the row's first device), the outputs joined along the
    batch on ``args[0]``'s device: ``jax.shard_map`` over dp. The batch
    must split evenly over dp (the engines round their buckets so)."""
    return _dp_rows(lambda _r, *shard: fn(*shard), mesh, *args)


def _dp_rows(fn, mesh: Mesh, *args: torch.Tensor):
    """``dp_map`` whose ``fn`` also takes the row's index first."""
    dp = mesh.shape["dp"]
    if dp == 1:
        return fn(0, *args)
    n = args[0].shape[0]
    if n % dp:
        raise ValueError(f"a batch of {n} does not split over dp={dp}: round it up to a "
                         "multiple of dp")
    c = n // dp
    outs = [fn(r, *(a[r * c:(r + 1) * c].to(mesh.lead(r)) for a in args))
            for r in range(dp)]
    return _join_outputs(outs, args[0].device)


def _to(obj, dev: torch.device):
    return obj.to(dev) if isinstance(obj, torch.Tensor) else obj


class ShardedModel:
    """``model``'s forward over ``mesh``, GSPMD's semantics: the input's
    batch splits over dp, each row runs its chunk on its devices, every
    splittable conv and dense (``_leaf_spec``: tp divides its output
    channels; float weights) is a ``TpSplit``, and the rows' outputs are
    joined along the batch on the input's device. The result equals one
    device's up to accumulation order.

    ``net`` holds the weights once, on row 0's devices: the tp slices on
    (0, t), the rest on (0, 0) (the model's own tensors). A row on other
    devices runs ``net`` through ``torch.func.functional_call`` on copies
    of its tensors (a copy of a tensor that takes gradients is
    differentiable, so a train step's gradients reach row 0's tensors from
    every row); rows on the same devices as row 0 call it directly. ``model`` must be on the mesh's
    first device. ``parameters`` are the sharded parameters (what a train
    step's optimizer updates); ``gather_into_module`` and
    ``scatter_from_module`` copy the tp slices to and from ``model``.

    On a (dp, sp, tp) mesh with sp > 1 a YOLO model's forward is banded
    (``spatial.banded_forward``): each row's images split by height over
    its sp ranks, each rank reads the weights copied to its own devices
    (a no-op where they are row 0's), and ``halo_copies`` counts the
    slices one rank fetched from another in the last call."""

    def __init__(self, model: nn.Module, mesh: Mesh):
        self.module, self.mesh = model, mesh
        tp = mesh.shape.get("tp", 1)
        self.sp = mesh.shape.get("sp", 1)
        if self.sp > 1:
            from .spatial import check_banded

            check_banded(model)
        self.halo_copies = 0
        row0 = list(mesh.grid[0, 0])
        self._pairs: List[Tuple[nn.Module, TpSplit]] = []
        for name, t in [*model.named_parameters(), *model.named_buffers()]:
            if t.device != row0[0]:
                raise ValueError(f"{name} is on {t.device}, not the mesh's first device "
                                 f"{row0[0]}")
        self.net = self._copy(model, row0, tp) if tp > 1 else model
        # each tensor's tp rank (replicated ones: 0, the row's first device)
        self._rank = {name: self._module_name(name)[1] or 0 for name, _ in self._tensors()}
        self._direct = [all(mesh.grid[r, 0, t] == mesh.grid[0, 0, t] for t in range(tp))
                        for r in range(mesh.shape["dp"])]

    def _copy(self, mod: nn.Module, row0: List[torch.device], tp: int) -> nn.Module:
        if _splits(mod, tp):
            split = TpSplit(mod, row0)
            self._pairs.append((mod, split))
            return split
        new = copy.copy(mod)  # the same tensors: replicated, on row 0's first device
        new._parameters = dict(mod._parameters)
        new._buffers = dict(mod._buffers)
        new._modules = {k: None if m is None else self._copy(m, row0, tp)
                        for k, m in mod._modules.items()}
        return new

    def _tensors(self):
        yield from self.net.named_parameters()
        yield from self.net.named_buffers()

    def parameters(self):
        return self.net.parameters()

    def named_parameters(self):
        return self.net.named_parameters()

    def __call__(self, x: torch.Tensor, *args, **kwargs):
        self.halo_copies = 0
        return _dp_rows(lambda r, xr: self._row(r, xr, args, kwargs), self.mesh, x)

    def _row(self, r: int, x: torch.Tensor, args, kwargs):
        lead = self.mesh.lead(r)
        x = x.to(lead)
        args = tuple(_to(a, lead) for a in args)
        kwargs = {k: _to(v, lead) for k, v in kwargs.items()}
        if self.sp > 1:
            from .spatial import banded_forward

            out, copies = banded_forward(self.net, self.mesh.grid[r], x, *args, **kwargs)
            self.halo_copies += copies
            return out
        if self._direct[r]:
            return self.net(x, *args, **kwargs)
        state = {name: t.to(self.mesh.grid[r, 0, self._rank[name]])
                 for name, t in self._tensors()}
        return torch.func.functional_call(self.net, state, (x, *args), kwargs)

    @staticmethod
    def _module_name(name: str) -> Tuple[str, Optional[int]]:
        """A sharded tensor's name in the model, and its tp rank (None:
        replicated): ``layers.0.parts.1.weight`` -> (``layers.0.weight``, 1)."""
        parts = name.split(".")
        if "parts" not in parts:
            return name, None
        i = parts.index("parts")
        return ".".join(parts[:i] + parts[i + 2:]), int(parts[i + 1])

    def joined(self, values: Dict[str, Optional[torch.Tensor]]) -> Dict:
        """Tensors keyed by the sharded parameters' names (gradients,
        moments) -> keyed by the model's, tp slices joined on row 0's first
        device (None where a slice has none)."""
        out: Dict = {}
        slices: Dict[str, Dict[int, Optional[torch.Tensor]]] = {}
        for name, v in values.items():
            whole, rank = self._module_name(name)
            if rank is None:
                out[whole] = v
            else:
                slices.setdefault(whole, {})[rank] = v
        dev = self.mesh.lead(0)
        for whole, by_rank in slices.items():
            vs = [by_rank[t] for t in sorted(by_rank)]
            out[whole] = None if any(v is None for v in vs) else torch.cat(
                [v.to(dev) for v in vs])
        return out

    def split(self, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Tensors keyed by the model's parameter names -> keyed by the
        sharded parameters' names (each tp rank's output-channel slice)."""
        out = {}
        for name, p in self.net.named_parameters():
            whole, rank = self._module_name(name)
            v = values[whole]
            out[name] = v if rank is None else v[rank * p.shape[0]:(rank + 1) * p.shape[0]]
        return out

    @torch.no_grad()
    def gather_into_module(self) -> None:
        """Copy the tp slices, joined, into ``model``'s own parameters (the
        replicated ones are ``model``'s own tensors)."""
        for mod, split in self._pairs:
            for name, whole in mod.named_parameters(recurse=False):
                whole.copy_(torch.cat([getattr(p, name).to(whole.device) for p in split.parts]))

    @torch.no_grad()
    def scatter_from_module(self) -> None:
        """Copy ``model``'s parameters into the tp slices (after a load)."""
        for mod, split in self._pairs:
            for name, whole in mod.named_parameters(recurse=False):
                for t, p in enumerate(split.parts):
                    getattr(p, name).copy_(whole[t * split.step:(t + 1) * split.step])
