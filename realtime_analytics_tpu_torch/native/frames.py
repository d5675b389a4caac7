"""The clip pack's native gather (``frames.c``): a list of frames copied
into one contiguous buffer in a single call, parallel over the frames.

Built and loaded as the package's ``hostops.c`` is (whose loader,
``native/__init__.py``, is kept equal to the JAX package's, so the port's
own native code has its own): the first call compiles ``frames.c`` into
the same cache (``build/native/`` in the checkout), with OpenMP when the
toolchain has it, and loads it with ctypes. ``gather``
returns False, having copied nothing, wherever it cannot take the frames:
no build, ``RVA_NO_NATIVE`` set, or a frame that is not uint8 of the
buffer's frame shape and C-contiguous; the caller then copies with numpy.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from . import _build_dir

logger = logging.getLogger(__name__)

_SRC = Path(__file__).parent / "frames.c"
_U8 = np.dtype(np.uint8)
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compile() -> Optional[Path]:
    out = _build_dir() / f"frames_{sys.platform}_{int(_SRC.stat().st_mtime)}.so"
    if out.exists():
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")  # renamed whole, never half-written
    for extra in (["-fopenmp"], []):
        try:
            proc = subprocess.run(
                ["cc", "-O3", *extra, "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
                capture_output=True, text=True, timeout=120)
            if proc.returncode == 0 and tmp.exists():
                os.replace(tmp, out)
                logger.info("built native frame gather (%s)",
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
        lib.gather_frames.restype = None
        lib.gather_frames.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_long, ctypes.c_long]
        lib.gather_threads.restype = ctypes.c_int
        lib.gather_threads.argtypes = []
        _lib = lib
    except Exception:  # noqa: BLE001 — native is best-effort
        logger.exception("native frame gather unavailable; using numpy")
        _lib = None
    return _lib


def _address(frame: np.ndarray) -> int:
    # from_buffer reads a writable frame's address in half the time of
    # frame.ctypes.data, which a read-only frame needs
    if frame.flags.writeable:
        return ctypes.addressof(ctypes.c_char.from_buffer(frame))
    return frame.ctypes.data


def gather(frames: Sequence[np.ndarray], out: np.ndarray) -> bool:
    """``out[k] = frames[k]`` for every k, in one native call, where ``out``
    is C-contiguous uint8 [len(frames), ...] and every frame is C-contiguous
    uint8 of ``out``'s frame shape; a frame may appear more than once.
    Returns whether it copied; where it did not, ``out`` is untouched."""
    lib = _load()
    shape = out.shape[1:]
    if (lib is None or len(frames) != len(out) or out.dtype != _U8
            or not out.flags.c_contiguous):
        return False
    addresses = []
    for f in frames:
        if f.dtype != _U8 or f.shape != shape or not f.flags.c_contiguous:
            return False
        addresses.append(_address(f))
    lib.gather_frames((ctypes.c_void_p * len(addresses))(*addresses), out.ctypes.data,
                      len(addresses), out[0].nbytes if len(out) else 0)
    return True


def threads() -> int:
    """The threads a gather runs on; 0 without the native build."""
    lib = _load()
    return lib.gather_threads() if lib is not None else 0
