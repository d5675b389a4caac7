"""Native host-side ops, built on demand (cc -O3 -shared, ctypes-loaded).

The port's own copy of the JAX package's ``native`` module. The device hot
path is PyTorch plus the CUDA kernels of ``csrc/``; the remaining *host*
hot path — the pixel pick that feeds the card under ``host_select`` — lives
here as a small C kernel. No build system, no pybind11: the first call
compiles ``hostops.c`` into a cached shared object under the checkout's
``build/native/`` (with OpenMP when the toolchain supports it) and loads it
with ctypes; any failure falls back to numpy (the same bytes, only slower).
RVA_NO_NATIVE=1 disables the native path entirely.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).parent / "hostops.c"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build_dir() -> Path:
    d = Path(
        os.environ.get("RVA_NATIVE_CACHE",
                       Path(__file__).resolve().parents[2] / "build" / "native")
    )
    d.mkdir(parents=True, exist_ok=True)
    return d


def _compile() -> Optional[Path]:
    src_mtime = int(_SRC.stat().st_mtime)
    out = _build_dir() / f"hostops_{sys.platform}_{src_mtime}.so"
    if out.exists():
        return out
    # compile to a process-unique temp file, then atomically rename: shard
    # launchers spawn many processes at once with a cold cache, and a
    # half-written .so must never be dlopen'd (or persist and poison the
    # cache into a permanent silent numpy fallback)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    for extra in (["-fopenmp"], []):  # prefer OpenMP, fall back without
        try:
            proc = subprocess.run(
                ["cc", "-O3", *extra, "-shared", "-fPIC", str(_SRC),
                 "-o", str(tmp)],
                capture_output=True, text=True, timeout=120,
            )
            if proc.returncode == 0 and tmp.exists():
                os.replace(tmp, out)
                logger.info("built native hostops (%s)",
                            "openmp" if extra else "single-thread")
                return out
        except (OSError, subprocess.TimeoutExpired):
            break
        finally:
            tmp.unlink(missing_ok=True)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("RVA_NO_NATIVE"):
        return None
    try:
        path = _compile()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.pick_u8.restype = None
        lib.pick_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.c_long,
        ]
        _lib = lib
    except Exception:  # noqa: BLE001 — native is best-effort
        logger.exception("native hostops unavailable; using numpy")
        _lib = None
    return _lib


def picked_shape(h: int, w: int, hr: int, hoff: int, wr: int,
                 woff: int) -> tuple:
    """(oh, ow) of ``pick_u8`` for an [H, W] source — the single source of
    truth for the pick's output geometry (engine and bench both allocate
    batch buffers from it)."""
    return (h - hoff + hr - 1) // hr, (w - woff + wr - 1) // wr


def pick_u8(frames: np.ndarray, hr: int, hoff: int, wr: int, woff: int,
            out: Optional[np.ndarray] = None) -> np.ndarray:
    """[N, H, W, 3] (or [H, W, 3]) uint8 -> picked contiguous array.
    Equivalent to ``np.ascontiguousarray(frames[..., hoff::hr, woff::wr, :])``
    but ~4-6x faster per core and OpenMP-parallel over frames.

    ``out``: optional preallocated C-contiguous destination of the exact
    output shape — lets callers pick straight into a batch buffer (one copy
    instead of pick-then-stack)."""
    squeeze = frames.ndim == 3
    if squeeze:
        frames = frames[None]
        if out is not None:
            out = out[None]
    n, h, w, c = frames.shape
    if c != 3 or frames.dtype != np.uint8:
        raise ValueError(f"pick_u8 needs uint8 HWC/NHWC with 3 channels, "
                         f"got {frames.dtype} {frames.shape}")
    oh, ow = picked_shape(h, w, hr, hoff, wr, woff)
    if out is not None and (
        out.shape != (n, oh, ow, 3) or out.dtype != np.uint8
        or not out.flags["C_CONTIGUOUS"]
    ):
        raise ValueError("pick_u8 out= must be C-contiguous uint8 "
                         f"{(n, oh, ow, 3)}, got {out.dtype} {out.shape}")
    lib = _load()
    if lib is None or not frames.flags["C_CONTIGUOUS"]:
        picked = np.ascontiguousarray(frames[:, hoff::hr, woff::wr])
        if out is not None:
            out[...] = picked
        else:
            out = picked
    else:
        if out is None:
            out = np.empty((n, oh, ow, 3), np.uint8)
        lib.pick_u8(
            frames.ctypes.data, out.ctypes.data,
            n, h, w, hr, hoff, wr, woff, oh, ow,
        )
    return out[0] if squeeze else out


def native_available() -> bool:
    return _load() is not None
