"""Genuine ByteTrack: two-stage association + Kalman motion model.

The reference only *labels* its IOU tracker "byte_track"
(reference tracker.py:38-43, README.md:295). This module implements the real
algorithm (Zhang et al., "ByteTrack: Multi-Object Tracking by Associating
Every Detection Box", ECCV 2022) behind ``tracker.type: byte_track_full``:

  1. split detections by confidence at ``high_thresh``;
  2. stage 1: Hungarian assignment of high-confidence detections to all
     live tracks on predicted-box IoU (min IoU ``match_thresh``);
  3. stage 2: the *low*-confidence leftovers rescue still-unmatched tracks
     (min IoU 0.5 — the paper's second gate) instead of being discarded,
     which is the core ByteTrack idea (occluded objects detect weakly but
     still overlap their track);
  4. unmatched high-confidence detections above ``new_track_thresh`` start
     new tracks; unmatched tracks age and drop after ``max_age``.

The motion model is the standard constant-velocity Kalman filter over
state [cx, cy, a, h, vcx, vcy, va, vh] (a = aspect ratio w/h), with the
ByteTrack noise weights (std_pos = h/20, std_vel = h/160). ``use_kalman:
false`` degrades to last-box IoU.

Interface-compatible with ``tracker.IouTracker`` (same Track objects, same
per-stream locking, same global monotonic ids), so the pipeline swaps
trackers via config alone.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .config import TrackerConfig
from .tracker import _TEMPORAL_FIELDS, _iou_matrix_np
from .types import Detection, Track

STAGE2_MATCH_THRESH = 0.5  # the paper's low-confidence association gate


# ---------------------------------------------------------------------------
# Kalman filter (constant velocity over [cx, cy, a, h])
# ---------------------------------------------------------------------------


class KalmanBoxFilter:
    """Per-track constant-velocity Kalman filter, ByteTrack formulation."""

    _std_weight_pos = 1.0 / 20.0
    _std_weight_vel = 1.0 / 160.0

    def __init__(self, xyxy: Tuple[float, float, float, float]):
        z = self._to_z(xyxy)
        self.x = np.zeros(8, dtype=np.float64)
        self.x[:4] = z
        h = z[3]
        std = [
            2 * self._std_weight_pos * h, 2 * self._std_weight_pos * h,
            1e-2, 2 * self._std_weight_pos * h,
            10 * self._std_weight_vel * h, 10 * self._std_weight_vel * h,
            1e-5, 10 * self._std_weight_vel * h,
        ]
        self.P = np.diag(np.square(std))
        self.F = np.eye(8)
        for i in range(4):
            self.F[i, i + 4] = 1.0
        self.H = np.eye(4, 8)

    @staticmethod
    def _to_z(xyxy) -> np.ndarray:
        x1, y1, x2, y2 = xyxy
        w = max(1e-6, x2 - x1)
        h = max(1e-6, y2 - y1)
        return np.asarray([x1 + w / 2, y1 + h / 2, w / h, h], dtype=np.float64)

    def predict(self) -> None:
        h = self.x[3]
        q = np.square([
            self._std_weight_pos * h, self._std_weight_pos * h, 1e-2,
            self._std_weight_pos * h,
            self._std_weight_vel * h, self._std_weight_vel * h, 1e-5,
            self._std_weight_vel * h,
        ])
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + np.diag(q)

    def update(self, xyxy) -> None:
        z = self._to_z(xyxy)
        h = self.x[3]
        r = np.square([
            self._std_weight_pos * h, self._std_weight_pos * h, 1e-1,
            self._std_weight_pos * h,
        ])
        S = self.H @ self.P @ self.H.T + np.diag(r)
        K = self.P @ self.H.T @ np.linalg.inv(S)
        self.x = self.x + K @ (z - self.H @ self.x)
        self.P = (np.eye(8) - K @ self.H) @ self.P

    def predicted_xyxy(self) -> Tuple[float, float, float, float]:
        cx, cy, a, h = self.x[:4]
        h = max(1e-6, h)
        w = max(1e-6, a * h)
        return (cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2)


# ---------------------------------------------------------------------------
# Association
# ---------------------------------------------------------------------------


def _assign(iou: np.ndarray, min_iou: float) -> List[Tuple[int, int]]:
    """Hungarian assignment on an IoU matrix, gated at min_iou.
    Returns (row=det index, col=track index) pairs."""
    if iou.size == 0:
        return []
    try:
        from scipy.optimize import linear_sum_assignment

        rows, cols = linear_sum_assignment(-iou)
        return [(int(r), int(c)) for r, c in zip(rows, cols)
                if iou[r, c] >= min_iou]
    except ImportError:  # pragma: no cover - scipy is in the image
        pairs = []
        used_r, used_c = set(), set()
        order = np.dstack(np.unravel_index(np.argsort(-iou, axis=None),
                                           iou.shape))[0]
        for r, c in order:
            if iou[r, c] < min_iou:
                break
            if r in used_r or c in used_c:
                continue
            pairs.append((int(r), int(c)))
            used_r.add(int(r))
            used_c.add(int(c))
        return pairs


class _ByteState:
    __slots__ = ("tracks", "kalman")

    def __init__(self) -> None:
        self.tracks: Dict[int, Track] = {}
        self.kalman: Dict[int, KalmanBoxFilter] = {}


class ByteTracker:
    """Real ByteTrack behind the IouTracker interface."""

    def __init__(self, config: TrackerConfig):
        self.config = config
        self._next_track_id = itertools.count(1)
        self._streams: Dict[str, _ByteState] = {}
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

    # -- core ----------------------------------------------------------------

    def _predicted_boxes(self, state: _ByteState, tids: List[int]) -> np.ndarray:
        boxes = []
        for tid in tids:
            kf = state.kalman.get(tid)
            if kf is not None:
                kf.predict()
                boxes.append(kf.predicted_xyxy())
            else:
                boxes.append(state.tracks[tid].bbox_xyxy)
        return np.asarray(boxes, dtype=np.float32).reshape(-1, 4)

    def _match(
        self,
        dets: List[Detection],
        det_idx: List[int],
        tids: List[int],
        pred: np.ndarray,
        classes: np.ndarray,
        min_iou: float,
    ) -> List[Tuple[int, int]]:
        if not det_idx or not tids:
            return []
        dboxes = np.asarray([dets[i].bbox_xyxy for i in det_idx], np.float32)
        dcls = np.asarray([dets[i].class_id for i in det_idx], np.int32)
        iou = _iou_matrix_np(dboxes, pred)
        iou = np.where(dcls[:, None] == classes[None, :], iou, 0.0)
        return [(det_idx[r], tids[c]) for r, c in _assign(iou, min_iou)]

    def _update(self, stream_name: str, dets: List[Detection]) -> List[Track]:
        cfg = self.config
        state = self._streams.setdefault(stream_name, _ByteState())
        tids = list(state.tracks.keys())
        pred = self._predicted_boxes(state, tids)
        tcls = np.asarray([state.tracks[t].class_id for t in tids], np.int32)

        high = [i for i, d in enumerate(dets) if d.confidence >= cfg.high_thresh]
        low = [
            i for i, d in enumerate(dets)
            if cfg.low_thresh <= d.confidence < cfg.high_thresh
        ]

        matched_tracks: set = set()
        matched_dets: set = set()

        # stage 1: high-confidence dets x all tracks
        for di, tid in self._match(dets, high, tids, pred, tcls,
                                   cfg.match_thresh):
            self._hit(state, tid, dets[di])
            matched_tracks.add(tid)
            matched_dets.add(di)

        # stage 2: LOW-confidence dets rescue the remaining CONFIRMED tracks
        # only — the paper restricts the second association to previously
        # tracked (activated) tracks, so low-confidence flicker can never
        # confirm a tentative track into a published ghost
        rem_idx = [
            k for k, t in enumerate(tids)
            if t not in matched_tracks
            and state.tracks[t].hits >= cfg.min_hits
        ]
        rem_tids = [tids[k] for k in rem_idx]
        if rem_tids and low:
            for di, tid in self._match(dets, low, rem_tids,
                                       pred[rem_idx], tcls[rem_idx],
                                       STAGE2_MATCH_THRESH):
                self._hit(state, tid, dets[di])
                matched_tracks.add(tid)
                matched_dets.add(di)

        # new tracks from unmatched confident detections
        for i in high:
            if i in matched_dets:
                continue
            if dets[i].confidence < cfg.new_track_thresh:
                continue
            if len(state.tracks) >= cfg.max_tracks_per_stream:
                break  # safety bound: no unbounded growth under noise
            matched_tracks.add(self._start(state, stream_name, dets[i]))

        # age + cull unmatched tracks: confirmed tracks persist as "lost"
        # until max_age (re-associable in later frames); unconfirmed
        # (tentative) tracks drop on their first miss, as in the paper
        for tid in list(state.tracks.keys()):
            if tid in matched_tracks:
                continue
            track = state.tracks[tid]
            track.age += 1
            if track.age > cfg.max_age or track.hits < cfg.min_hits:
                del state.tracks[tid]
                state.kalman.pop(tid, None)

        # emission: confirmed tracks only (tentative ones stay internal
        # until they reach min_hits — the paper's unconfirmed state)
        return [t for t in state.tracks.values() if t.hits >= cfg.min_hits]

    def _hit(self, state: _ByteState, tid: int, det: Detection) -> None:
        track = state.tracks[tid]
        if self.config.use_kalman:
            kf = state.kalman.get(tid)
            if kf is None:
                kf = state.kalman[tid] = KalmanBoxFilter(det.bbox_xyxy)
            kf.update(det.bbox_xyxy)
            track.bbox_xyxy = kf.predicted_xyxy()
        else:
            track.bbox_xyxy = tuple(det.bbox_xyxy)
        track.confidence = det.confidence
        track.hits += 1
        track.age = 0
        for f in _TEMPORAL_FIELDS:
            if hasattr(det, f):
                setattr(track, f, getattr(det, f))

    def _start(self, state: _ByteState, stream_name: str, det: Detection) -> int:
        temporal = {
            f: getattr(det, f) for f in _TEMPORAL_FIELDS if hasattr(det, f)
        }
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
        if self.config.use_kalman:
            state.kalman[track.track_id] = KalmanBoxFilter(det.bbox_xyxy)
        return track.track_id

    # -- interface parity ------------------------------------------------------

    def active_track_count(self, stream_name: str) -> int:
        state = self._streams.get(stream_name)
        return len(state.tracks) if state else 0

    def reset_stream(self, stream_name: str) -> None:
        with self._lock_for(stream_name):
            self._streams.pop(stream_name, None)


def create_tracker(config: TrackerConfig):
    """Tracker factory: the reference-contract IOU shim by default,
    genuine ByteTrack for ``type: byte_track_full``."""
    from .tracker import IouTracker

    if config.type == "byte_track_full":
        return ByteTracker(config)
    return IouTracker(config)
