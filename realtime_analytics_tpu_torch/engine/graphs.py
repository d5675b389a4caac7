"""One prepared program per bucket: the YOLO engines' device steps,
captured once as CUDA graphs and replayed.

Counterpart of the JAX engines' ``_steps`` cache, where the whole chain "is
ONE ``jax.jit`` graph with static shapes, compiled once per (batch bucket x
source resolution) and reused forever" (``realtime_analytics_tpu/engine/
detector.py``). A ``TorchYoloEngine`` keeps its steps in a ``StepCache``
under JAX's keys, ``(B, H, W, "sel")`` for the selected step and ``(B, H,
W)`` for the device-resize step. On the card an entry is a
``CapturedStep``: the eager step run a few times on a side stream (the
first-use kernel build, cuDNN's plans and the allocator settle there), then
one call captured with ``torch.cuda.graph``, then replayed for every batch
of its key. A replay is one ``cudaGraphLaunch`` where the eager step makes
some 300 PyTorch calls and as many kernel launches.

What a replay relies on:

* no host wait inside the step: a capture raises at the first operation
  that synchronises or copies from pageable memory;
* every tensor the step reads besides its input stays where it was at the
  capture (the weights, the prepared state, B4's tables, which the warm
  runs make); the batch is copied into the step's static input;
* one replay at a time, and each replay's outputs copied out before the
  next: one lock an engine. That also makes the memory pool that an
  engine's graphs share safe: their intermediates reuse the same blocks,
  while each graph's outputs are held for its life and alias nothing.

Launches: the kernels' wrappers count in Python (``ops/_cuda.py``), so a
capture counts once and a replay counts nothing. A ``CapturedStep``
records what its capture counted, takes it back (a capture launches
nothing) and adds it again at each replay, so ``LAUNCHES`` reads per step
what the eager step counts.

``EagerStep`` has the same interface over the eager function. An engine
keeps it in the same cache where it does not capture, as decided by its own
state: on the CPU (torch has no CPU graph), under a mesh, and on a
graph-backed ONNX engine.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops._cuda import LAUNCHES
from ..telemetry import spans

WARM_RUNS = 2  # eager runs of a step on a side stream before its capture

# CUDA allows one capture at a time in a process; engines capture under it
_CAPTURE = threading.Lock()

Step = Callable[[torch.Tensor], Tuple[torch.Tensor, ...]]


class StepCache(dict):
    """An engine's steps by key, and what its captured steps share: the
    lock that serialises their captures and replays, and one memory pool
    on the card (made at the first capture)."""

    def __init__(self) -> None:
        super().__init__()
        self.lock = threading.Lock()
        self._pool = None

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def setdefault_made(self, key, make: Callable[[], object]):
        """The step of ``key``, made by ``make()`` under the lock at its
        first use (a thread that asks meanwhile waits for it)."""
        step = self.get(key)
        if step is None:
            with self.lock:
                step = self.get(key)
                if step is None:
                    step = self[key] = make()
        return step

    def pool_mib(self) -> Optional[float]:
        """MiB the card holds in this cache's pool (the segments of the
        caching allocator's snapshot that belong to it); None before the
        first capture."""
        if self._pool is None:
            return None
        pool = tuple(self._pool)
        segs = torch.cuda.memory._snapshot()["segments"]
        return sum(s["total_size"] for s in segs
                   if tuple(s.get("segment_pool_id", ())) == pool) / 2**20


class CudaGraph:
    """``torch.cuda.CUDAGraph`` behind the three calls that ``CapturedStep``
    makes, so that a test can stand a fake in for it."""

    def __init__(self, pool) -> None:
        self._pool = pool
        self._graph = torch.cuda.CUDAGraph()

    def warm(self, fn: Step, x: torch.Tensor) -> None:
        dev = x.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARM_RUNS):
                fn(x)
        torch.cuda.current_stream(dev).wait_stream(side)

    def capture(self, fn: Step, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        # thread_local: the batcher's other threads may use the card meanwhile
        with torch.cuda.graph(self._graph, pool=self._pool, capture_error_mode="thread_local"):
            return tuple(fn(x))

    def replay(self) -> None:
        self._graph.replay()


class CapturedStep:
    """A device step of one input shape, captured once and replayed.

    ``fn`` maps the static input ([B, H, W, 3] uint8 on the card) to a tuple
    of tensors. Construction (under the cache's lock) warms ``fn`` and
    captures it; each call copies its batch into the static input, replays
    and copies the outputs out, under the lock."""

    def __init__(self, fn: Step, shape: Sequence[int], dtype: torch.dtype,
                 device: torch.device, *, key, cache: StepCache, graph_type=None):
        self.key, self.shape, self.dtype = key, tuple(int(v) for v in shape), dtype
        self._lock = cache.lock
        t0 = time.perf_counter()
        with _CAPTURE, torch.inference_mode():
            self.input = torch.zeros(self.shape, dtype=dtype, device=device)
            self._graph = (graph_type or CudaGraph)(cache.pool())
            self._graph.warm(fn, self.input)
            before = LAUNCHES.local()
            try:
                self.outputs = self._graph.capture(fn, self.input)
            except RuntimeError as exc:
                raise RuntimeError(f"capturing the device step {key} failed: {exc}") from exc
            after = LAUNCHES.local()
        self.launches: Dict[str, int] = {k: after[k] - before[k] for k in after
                                         if after[k] != before[k]}
        for name, n in self.launches.items():  # a capture launches nothing
            LAUNCHES.add(name, -n)
        self.capture_s = time.perf_counter() - t0

    def _replay(self, x: torch.Tensor) -> None:
        if tuple(x.shape) != self.shape or x.dtype != self.dtype:
            raise ValueError(f"step {self.key} was captured for {self.dtype} {self.shape}, "
                             f"got {x.dtype} {tuple(x.shape)}")
        self.input.copy_(x)
        with spans.span("captured_step"):
            self._graph.replay()
        for name, n in self.launches.items():
            LAUNCHES.add(name, n)

    @contextlib.contextmanager
    def _stepping(self):
        """The step's lock, the wait for it a ``lock`` span, and the work
        under it a ``step`` span."""
        with spans.span("lock"):
            self._lock.acquire()
        try:
            with spans.span("step"), torch.inference_mode():
                yield
        finally:
            self._lock.release()

    def __call__(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The step on ``x`` (on the card or the host): its outputs as new
        tensors on the card."""
        with self._stepping():
            self._replay(x)
            return tuple(t.clone() for t in self.outputs)

    def run_host(self, frames: np.ndarray) -> Tuple[np.ndarray, ...]:
        """The step on a host batch: uploaded into the static input, the
        outputs copied back to the host."""
        with self._stepping():
            self._replay(torch.from_numpy(np.ascontiguousarray(frames)))
            return tuple(t.to("cpu", copy=True).numpy() for t in self.outputs)


class EagerStep:
    """The eager step behind ``CapturedStep``'s interface. It allocates its
    own tensors each call, so calls may run at once."""

    def __init__(self, fn: Step, device: torch.device) -> None:
        self._fn, self._device = fn, device

    def __call__(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        with torch.inference_mode():
            return tuple(self._fn(x.to(self._device)))

    def run_host(self, frames: np.ndarray) -> Tuple[np.ndarray, ...]:
        with spans.span("step"), torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(frames)).to(self._device)
            return tuple(t.cpu().numpy() for t in self._fn(x))
