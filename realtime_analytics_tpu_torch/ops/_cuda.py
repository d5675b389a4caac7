"""Build, load and launch the port's hand-written CUDA kernels (``csrc/``).

Route: ``nvcc`` compiles each ``csrc/*.cu`` file for ``sm_90a`` (one
process per source, all started together), links the objects into one
shared library with a plain C interface under the checkout's
``build/torch_kernels/``, and ``ctypes`` loads it. The library's file name
carries a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the build. Nothing here runs at import time: the
first launch builds.

Every C entry launches on PyTorch's current stream, allocates nothing and
returns ``cudaGetLastError()``; ``check`` raises on a non-zero code. There
is no fallback: a CUDA tensor either launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

logger = logging.getLogger(__name__)

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(
    os.environ.get(
        "RVA_TORCH_KERNELS_DIR",
        Path(__file__).resolve().parents[2] / "build" / "torch_kernels",
    )
)
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# the kernels of this package, by wrapper name
KERNELS = ("row_gather", "decode_v8", "fused_stem")


class LaunchCounter:
    """One integer per kernel: how many times its wrapper launched it.

    A wrapper adds one where it launches its kernel and nowhere else, so a
    run can show that its path really went through the kernels. The batcher
    calls the engine from several threads, hence the lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = dict.fromkeys(KERNELS, 0)

    def add(self, name: str) -> None:
        with self._lock:
            self.counts[name] += 1

    def reset(self) -> None:
        with self._lock:
            self.counts = dict.fromkeys(KERNELS, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counts)


LAUNCHES = LaunchCounter()


@dataclass
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when an existing build was reused
    ptxas: List[str] = field(default_factory=list)  # -Xptxas -v lines


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build: Optional[BuildInfo] = None


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of realtime_analytics_tpu_torch "
        "are built from csrc/ with the CUDA toolkit at first use (set "
        "CUDA_HOME or put nvcc on PATH)"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile csrc/*.cu into one .so (or reuse the build for these
    sources). Raises with nvcc's output when a source does not compile."""
    global _build
    with _lock:
        if _build is not None:
            return _build
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        key = _source_hash()
        so = BUILD_DIR / f"rva_kernels_{key}.so"
        log = BUILD_DIR / f"rva_kernels_{key}.ptxas.txt"
        if so.exists():
            lines = log.read_text().splitlines() if log.exists() else []
            _build = BuildInfo(so, 0.0, lines)
            return _build
        nvcc = _nvcc()
        t0 = time.perf_counter()
        tag = f"{key}.{os.getpid()}"
        objs, procs = [], []
        for src in _sources():
            obj = BUILD_DIR / f"{src.stem}.{tag}.o"
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        ptxas: List[str] = []
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            ptxas += [ln for ln in out.splitlines() if "ptxas" in ln]
            if proc.returncode != 0:
                failed.append(f"--- {src.name} (rc={proc.returncode})\n{out}")
        if failed:
            for obj in objs:
                obj.unlink(missing_ok=True)
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = BUILD_DIR / f"rva_kernels_{tag}.tmp.so"
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        for obj in objs:
            obj.unlink(missing_ok=True)
        if link.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
        log.write_text("\n".join(ptxas) + "\n")
        os.replace(tmp, so)  # atomic: a half-written .so is never loaded
        _build = BuildInfo(so, time.perf_counter() - t0, ptxas)
        logger.info("built CUDA kernels %s in %.1fs", so.name, _build.seconds)
        return _build


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:
        return _lib
    info = build()
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(info.path))
            p, i, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                            ctypes.c_float)
            # every launch entry takes the CUDA device index first
            handle.rva_row_gather.argtypes = [i, p, p, p, i, i64, i, i, p]
            handle.rva_decode_v8.argtypes = [i, p, p, p, p, p, i, i, i, i, f,
                                             i, p]
            handle.rva_fused_stem.argtypes = [i, p, p, p, p, p, p, i, i, i, i,
                                              i, i, p]
            handle.rva_cuda_error_string.argtypes = [i]
            handle.rva_cuda_error_string.restype = ctypes.c_char_p
            for fn in ("rva_row_gather", "rva_decode_v8", "rva_fused_stem"):
                getattr(handle, fn).restype = i
            _lib = handle
    return _lib


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = lib().rva_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed ({rc}: {msg})")


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """All tensors on one CUDA device -> that device; else raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(
                f"{name}: tensors must share one CUDA device, got "
                f"{[str(x.device) for x in tensors]}"
            )
    return dev
