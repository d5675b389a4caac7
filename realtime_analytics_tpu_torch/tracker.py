"""IOU tracker with vectorized association.

Behavioral contract (reference ``tracker.py:36-147``):
  * one tracker instance is shared by all streams, keyed internally by stream
    name, so track ids are globally unique and monotonically increasing;
  * greedy per-detection matching, same-class only, minimum IoU =
    ``max_iou_distance`` (the reference name says "distance" but the code
    treats it as a minimum IoU — preserved);
  * a detection may match a track created or already matched earlier in the
    same update (the reference searches the live dict as it grows);
  * unmatched tracks age by one per update; a track is dropped when
    ``age > max_age`` or ``hits < min_hits``;
  * ``update`` returns *all* live tracks, not just matched ones.

The per-detection IoU search is vectorized over the track set (the reference
does a pure-Python O(T) scalar loop per detection, tracker.py:97-109).
Temporal fields on TemporalDetections pass through onto tracks.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, Iterable, List

import numpy as np

from .config import TrackerConfig
from .types import Detection, Track

_TEMPORAL_FIELDS = (
    "action_label",
    "temporal_score",
    "sequence_start_frame",
    "sequence_end_frame",
)


class _StreamState:
    __slots__ = ("tracks", "boxes", "classes")

    def __init__(self) -> None:
        self.tracks: Dict[int, Track] = {}
        self.boxes = np.zeros((0, 4), dtype=np.float32)
        self.classes = np.zeros((0,), dtype=np.int32)

    def rebuild_arrays(self) -> None:
        if self.tracks:
            self.boxes = np.array(
                [t.bbox_xyxy for t in self.tracks.values()], dtype=np.float32
            )
            self.classes = np.array(
                [t.class_id for t in self.tracks.values()], dtype=np.int32
            )
        else:
            self.boxes = np.zeros((0, 4), dtype=np.float32)
            self.classes = np.zeros((0,), dtype=np.int32)


def _iou_matrix_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU, [M, 4] x [N, 4] -> [M, N] (reference _iou semantics:
    zero-area unions give 0)."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return np.zeros((a.shape[0], b.shape[0]), dtype=np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0.0, None), axis=-1)
    area_a = np.clip(a[:, 2] - a[:, 0], 0.0, None) * np.clip(
        a[:, 3] - a[:, 1], 0.0, None
    )
    area_b = np.clip(b[:, 2] - b[:, 0], 0.0, None) * np.clip(
        b[:, 3] - b[:, 1], 0.0, None
    )
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0.0, inter / np.maximum(union, 1e-12), 0.0).astype(
        np.float32
    )


class IouTracker:
    """ByteTrack-compatible-shaped IOU tracker (see module docstring)."""

    def __init__(self, config: TrackerConfig):
        self.config = config
        # itertools.count.__next__ is atomic under CPython — the global id
        # stream stays monotonic across concurrent per-stream updates
        self._next_track_id = itertools.count(1)
        self._streams: Dict[str, _StreamState] = {}
        # per-stream locks: states are independent, so updates for different
        # streams run concurrently on executor threads (the pipeline offloads
        # update() with asyncio.to_thread); a registry lock guards creation.
        self._registry_lock = threading.Lock()
        self._stream_locks: Dict[str, threading.Lock] = {}

    def _lock_for(self, stream_name: str) -> threading.Lock:
        with self._registry_lock:
            lock = self._stream_locks.get(stream_name)
            if lock is None:
                lock = self._stream_locks[stream_name] = threading.Lock()
            return lock

    def update(
        self, stream_name: str, detections: Iterable[Detection]
    ) -> List[Track]:
        with self._lock_for(stream_name):
            return self._update(stream_name, list(detections))

    def _update(self, stream_name: str, detections: List[Detection]) -> List[Track]:
        state = self._streams.setdefault(stream_name, _StreamState())
        track_ids: List[int] = list(state.tracks.keys())
        matched: set = set()
        n_det = len(detections)
        thresh = self.config.max_iou_distance

        n_tracks = state.boxes.shape[0]
        if n_det:
            det_boxes = np.asarray(
                [d.bbox_xyxy for d in detections], dtype=np.float32
            )
            det_classes = np.asarray(
                [d.class_id for d in detections], dtype=np.int32
            )
            # ONE vectorized pass: detections x [existing tracks ; detections]
            # (a later detection may match a track created — or re-boxed — by
            # an earlier one in this same update: reference semantics, its
            # loop searches the growing dict). Class-gate + threshold-mask to
            # -1 in the same shot.
            all_boxes = np.concatenate([state.boxes, det_boxes], axis=0)
            all_classes = np.concatenate([state.classes, det_classes])
            iou = _iou_matrix_np(det_boxes, all_boxes)  # [D, T+D]
            iou = np.where(
                (det_classes[:, None] == all_classes[None, :]) & (iou >= thresh),
                iou,
                -1.0,
            )
            iou_t = iou[:, :n_tracks]
            iou_d = iou[:, n_tracks:]
            # vectorized best-existing-track per detection, repaired lazily
            # when a matched track's box changes
            if n_tracks:
                best_idx = np.argmax(iou_t, axis=1)
                best_val = iou_t[np.arange(n_det), best_idx]
            else:
                best_idx = np.full(n_det, -1)
                best_val = np.full(n_det, -1.0)

        new_src: List[int] = []  # detection index that spawned each new track
        for j, det in enumerate(detections):
            best_iou, match_idx, match_new = -1.0, -1, -1
            if n_tracks and best_val[j] > -1.0:
                best_iou, match_idx = float(best_val[j]), int(best_idx[j])
            for nn, src in enumerate(new_src):
                v = iou_d[j, src]
                if v > best_iou:
                    best_iou, match_idx, match_new = float(v), -1, nn

            temporal = {
                f: getattr(det, f) for f in _TEMPORAL_FIELDS if hasattr(det, f)
            }
            if best_iou < 0.0:
                if len(state.tracks) >= self.config.max_tracks_per_stream:
                    continue  # safety bound: no unbounded growth under noise
                track = Track(
                    track_id=next(self._next_track_id),
                    stream_name=stream_name,
                    class_id=det.class_id,
                    confidence=det.confidence,
                    bbox_xyxy=tuple(det.bbox_xyxy),
                    age=0,
                    hits=1,
                    **temporal,
                )
                state.tracks[track.track_id] = track
                track_ids.append(track.track_id)
                new_src.append(j)
                matched.add(track.track_id)
            else:
                if match_new >= 0:
                    tid = track_ids[len(track_ids) - len(new_src) + match_new]
                    # the new track now sits at detection j's box
                    new_src[match_new] = j
                else:
                    tid = track_ids[match_idx]
                    # the matched track's box becomes detection j's box;
                    # column j of the det x det block already carries the
                    # right class+threshold mask (same class as the track).
                    # Repair the per-row best lazily:
                    col = iou_d[:, j]
                    improved = col > best_val
                    best_val[improved] = col[improved]
                    best_idx[improved] = match_idx
                    worsened = (best_idx == match_idx) & (col < best_val)
                    if worsened.any():
                        iou_t[:, match_idx] = col
                        rows = np.nonzero(worsened)[0]
                        best_idx[rows] = np.argmax(iou_t[rows], axis=1)
                        best_val[rows] = iou_t[rows, best_idx[rows]]
                    else:
                        iou_t[:, match_idx] = col
                track = state.tracks[tid]
                track.bbox_xyxy = tuple(det.bbox_xyxy)
                track.confidence = det.confidence
                track.hits += 1
                track.age = 0
                for key, value in temporal.items():
                    setattr(track, key, value)
                matched.add(tid)

        # prune: unmatched tracks age, then lifecycle cull
        for tid in list(state.tracks.keys()):
            if tid in matched:
                continue
            track = state.tracks[tid]
            track.age += 1
            if track.age > self.config.max_age or track.hits < self.config.min_hits:
                del state.tracks[tid]
        state.rebuild_arrays()
        return list(state.tracks.values())

    def active_track_count(self, stream_name: str) -> int:
        state = self._streams.get(stream_name)
        return len(state.tracks) if state else 0

    def reset_stream(self, stream_name: str) -> None:
        """Drop all tracks of one stream (e.g. after a reconnect)."""
        with self._lock_for(stream_name):
            self._streams.pop(stream_name, None)
