"""Deterministic synthetic video source.

URL scheme: ``synthetic://?width=640&height=480&boxes=2&frames=0&pool=0``
(plus ``min_size``/``max_size`` — box size as a fraction of the frame)
(``frames=0`` means endless; ``pool=N`` pre-renders N frames at open time
and cycles them, taking the ~6 MB/frame 1080p render cost out of the read
path — real cameras pay decode in native ffmpeg code, not Python). Produces BGR uint8 frames with moving bright
rectangles on a dark background — enough signal for motion filters, trackers
and end-to-end tests without ffmpeg, files or network (the reference's
closest analog is its bundled demo.mp4 fixture + the ffmpeg simulator).
"""

from __future__ import annotations

from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

# Process-level pool cache: a pooled source's frames are fully determined
# by (width, height, boxes, seed, pool, min_size, max_size) — the render
# consumes rng state deterministically from the seed — so re-opening the
# same URL (reconnects, bench pre-render, the host-scaled re-run) reuses
# the rendered frames instead of paying the ~6 MB/frame 1080p render
# again. Frames are treated as immutable by every consumer (they are
# already shared across read() cycles within one source). Bounded by
# spec count; live pipelines hold the same arrays anyway.
_POOL_CACHE: dict = {}
_POOL_CACHE_MAX_SPECS = 64


def prerender_pool(url: str) -> int:
    """Render (and cache) the pool for a ``synthetic://`` URL; returns the
    pool length (0 when the URL has no ``pool=``). Benchmarks call this
    BEFORE their timed window so startup measures the framework, not the
    synthetic decoder stand-in."""
    src = SyntheticSource.from_url(url)
    n = len(src._pool or ())
    src.release()
    return n


class SyntheticSource:
    def __init__(
        self,
        width: int = 640,
        height: int = 480,
        boxes: int = 2,
        max_frames: int = 0,
        seed: int = 0,
        fail_after: Optional[int] = None,
        pool: int = 0,
        min_size: float = 0.08,
        max_size: float = 0.2,
    ):
        self.width = width
        self.height = height
        self.n_boxes = boxes
        self.max_frames = max_frames
        self.fail_after = fail_after
        self._i = 0
        rng = np.random.default_rng(seed)
        self._pos = rng.uniform(0.1, 0.7, (boxes, 2))
        self._vel = rng.uniform(-0.01, 0.01, (boxes, 2)) + 0.003
        # size range as a fraction of the frame dimension; small values
        # (e.g. 0.02-0.05) make small-object scenes for tiling tests
        self._size = rng.uniform(min_size, max_size, (boxes, 2))
        self._colors = rng.integers(120, 256, (boxes, 3))
        self._opened = True
        # pool > 0: pre-render `pool` frames at construction and cycle them
        # at read() time. A 1080p render is ~6 MB of memset+fill per frame —
        # real cameras pay that in the ffmpeg/cv2 DECODER, not in Python, so
        # benchmarks that keep rendering in the timed path measure the bench
        # host, not the framework. Boxes still move across the pooled frames
        # (the tracker does real association work); motion wraps at `pool`.
        self._pool: Optional[list] = None
        if pool > 0:
            key = (width, height, boxes, seed, pool, min_size, max_size)
            cached = _POOL_CACHE.get(key)
            if cached is None:
                cached = []
                for _ in range(pool):
                    ok, frame, bx, cl = self._render_labeled()
                    if not ok:
                        break
                    cached.append((frame, bx, cl))
                if len(_POOL_CACHE) < _POOL_CACHE_MAX_SPECS:
                    _POOL_CACHE[key] = cached
            self._pool = cached
            self._i = 0
        # pooled reads are dict lookups — safe to run inline on the event
        # loop (ingest.video_stream skips its to_thread hop when set)
        self.fast_read = self._pool is not None

    @classmethod
    def from_url(cls, url: str) -> "SyntheticSource":
        q = parse_qs(urlparse(url).query)

        def geti(name, default):
            return int(q[name][0]) if name in q else default

        def getf(name, default):
            return float(q[name][0]) if name in q else default

        return cls(
            width=geti("width", 640),
            height=geti("height", 480),
            boxes=geti("boxes", 2),
            max_frames=geti("frames", 0),
            seed=geti("seed", 0),
            fail_after=geti("fail_after", 0) or None,
            pool=geti("pool", 0),
            min_size=getf("min_size", 0.08),
            max_size=getf("max_size", 0.2),
        )

    def isOpened(self) -> bool:  # cv2.VideoCapture API shape
        return self._opened

    def _render_labeled(self):
        """Render one frame and its ground-truth boxes (no frame counting)."""
        frame = np.full((self.height, self.width, 3), 24, dtype=np.uint8)
        self._pos = self._pos + self._vel
        # bounce off edges
        for d in range(2):
            over = (self._pos[:, d] < 0.0) | (self._pos[:, d] + self._size[:, d] > 1.0)
            self._vel[over, d] *= -1
        self._pos = np.clip(self._pos, 0.0, 1.0 - self._size)
        for b in range(self.n_boxes):
            x0 = int(self._pos[b, 0] * self.width)
            y0 = int(self._pos[b, 1] * self.height)
            x1 = min(self.width, x0 + int(self._size[b, 0] * self.width))
            y1 = min(self.height, y0 + int(self._size[b, 1] * self.height))
            frame[y0:y1, x0:x1] = self._colors[b]
        boxes = np.empty((self.n_boxes, 4), np.float32)
        boxes[:, 0] = self._pos[:, 0] * self.width
        boxes[:, 1] = self._pos[:, 1] * self.height
        boxes[:, 2] = boxes[:, 0] + self._size[:, 0] * self.width
        boxes[:, 3] = boxes[:, 1] + self._size[:, 1] * self.height
        classes = np.arange(self.n_boxes, dtype=np.int32)
        return True, frame, boxes, classes

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        ok, frame, _, _ = self.read_labeled()
        return ok, frame

    def read_labeled(self):
        """(ok, frame, boxes_xyxy [n_boxes, 4] float px, class_ids [n_boxes])
        — ground-truth boxes for the rendered rectangles, enabling supervised
        training/eval without datasets (see scripts/train.py). Class id = the
        rectangle's index (stable per source)."""
        if not self._opened:
            return False, None, None, None
        if self.max_frames and self._i >= self.max_frames:
            return False, None, None, None
        if self.fail_after is not None and self._i >= self.fail_after:
            return False, None, None, None
        if self._pool is not None:
            if not self._pool:
                return False, None, None, None
            frame, boxes, classes = self._pool[self._i % len(self._pool)]
            self._i += 1
            return True, frame, boxes, classes
        self._i += 1
        return self._render_labeled()

    def release(self) -> None:
        self._opened = False

    def get(self, *_args) -> float:  # cv2 prop API compatibility
        return 0.0

    def set(self, *_args) -> bool:
        return True
