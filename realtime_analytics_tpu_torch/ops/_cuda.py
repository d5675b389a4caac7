"""Build, load and launch the port's hand-written CUDA kernels (``csrc/``).

Route: ``nvcc`` compiles each ``csrc/*.cu`` file for ``sm_90a`` (one
process per source, all started together), links the objects into one
shared library with a plain C interface under the checkout's
``build/torch_kernels/``, and ``ctypes`` loads it. The library's file name
carries a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the build. Nothing here runs at import time: the
first launch builds.

Every C entry launches on PyTorch's current stream, allocates nothing and
returns ``cudaGetLastError()``; a wrapper raises (``fail``) on a non-zero
code. There is no fallback: a CUDA tensor either launches its kernel or
raises.

Each C entry is safe inside a CUDA graph capture (``engine/graphs.py``):
it launches on the current stream (the capture's during a capture), its
launch arguments are copied into the graph by value, and it waits on
nothing. What happens once (the ``nvcc`` build, the library load, the
shared-memory limit that B3's and B6's entries raise once per device)
happens in the eager warm runs before a capture. B4's entry raises its
kernel's limit at each launch that stages more than 48 KB; that is no
stream operation, and the device-resize step captures with it.

The launch path is kept short, because the small kernels cost the host
more than the card: a wrapper binds its C entry once (``entry``) and calls
the bound function, takes the raw stream as an int (``stream_of``), and
counts its launch without a lock (``LaunchCounter``).

Each kernel is also a registered torch op in the ``rva`` namespace
(``rva::row_gather``, ``rva::decode_v8_levels``, ``rva::fused_stem_p1p2``,
``rva::letterbox``, ``rva::nms_keep_boxes``, ``rva::nms_keep``,
``rva::conv_epilogue``, ``rva::rel_pos_attention``; each module registers
its own): a CUDA implementation that reaches the same C entry and counts the same
launch, a CPU implementation that is the plain version, and a fake one that
gives the output's shape and dtype. ``torch.export`` keeps such an op as
one node, so an exported serving step (``engine/export.py``) launches the
kernels when it is replayed. A wrapper routes through its op only while
``through_ops`` is active on the calling thread (the exporter traces under
it); the live engine calls the bound C entry directly, which costs the host
less than the op's dispatch.
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
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional

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
KERNELS = ("row_gather", "decode_v8", "fused_stem", "letterbox", "nms_keep",
           "conv_epilogue", "rel_pos_attention")

_route = threading.local()


def routed_through_ops() -> bool:
    """The wrappers call their registered ops (not the C entries) on this
    thread: inside ``through_ops``."""
    return getattr(_route, "ops", False)


@contextmanager
def through_ops() -> Iterator[None]:
    """Route this thread's wrapper calls through the registered ``rva``
    ops, so that a trace keeps each kernel as one node."""
    before = routed_through_ops()
    _route.ops = True
    try:
        yield
    finally:
        _route.ops = before


class LaunchCounter:
    """One integer per kernel: how many times its wrapper launched it.

    A wrapper adds one where it launches its kernel and nowhere else, so a
    run can show that its path really went through the kernels. The batcher
    calls the engine from several threads, so each thread counts in a
    table of its own (only its owner writes it: ``add`` takes no lock), and
    ``snapshot`` sums the tables. ``reset`` zeroes nothing, which would race
    with an ``add`` in flight: it records the sums as the new baseline."""

    def __init__(self) -> None:
        self._local = threading.local()
        self._lock = threading.Lock()  # the list of tables and the baseline
        self._tables: List[Dict[str, int]] = []
        self._base: Dict[str, int] = dict.fromkeys(KERNELS, 0)

    def add(self, name: str, n: int = 1) -> None:
        """Count ``n`` launches of ``name`` on this thread (a replayed CUDA
        graph adds the launches its capture recorded: ``engine/graphs.py``)."""
        try:
            self._local.counts[name] += n
        except AttributeError:  # this thread's first launch
            counts = self._local.counts = dict.fromkeys(KERNELS, 0)
            with self._lock:
                self._tables.append(counts)
            counts[name] += n

    def local(self) -> Dict[str, int]:
        """A copy of this thread's counts since it first counted."""
        counts = getattr(self._local, "counts", None)
        return dict(counts) if counts is not None else dict.fromkeys(KERNELS, 0)

    def _sums(self) -> Dict[str, int]:
        return {k: sum(t[k] for t in self._tables) for k in KERNELS}

    def reset(self) -> None:
        with self._lock:
            self._base = self._sums()

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            sums = self._sums()
            return {k: sums[k] - self._base[k] for k in KERNELS}


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
    """The sources nvcc compiles: a name that starts with ``_`` is a file
    the others include."""
    return sorted(p for p in CSRC.glob("*.cu") if not p.name.startswith("_"))


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
    for src in sorted(CSRC.glob("*.cu")):
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
            # -Xptxas -v: the "ptxas info" lines and, indented under each
            # function, its stack frame and spill bytes
            ptxas += [ln for ln in out.splitlines() if "ptxas" in ln or "spill" in ln]
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
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            # every launch entry takes the CUDA device index first
            handle.rva_row_gather.argtypes = [i, p, p, p, i, i64, i, i, p]
            handle.rva_decode_v8_levels.argtypes = [i, *[p] * 12, i, i, i, p]
            handle.rva_fused_stem.argtypes = [i, p, p, p, p, p, p, p, p, i, i,
                                              i, i, i, i, i, p]
            handle.rva_letterbox.argtypes = [i, p, p, p, p, p, *[i] * 15, p]
            handle.rva_nms_keep.argtypes = [i, p, p, p, p, i, i, i, p]
            handle.rva_nms_keep_boxes.argtypes = [i, p, p, p, p, i, i, ctypes.c_float, i, p]
            handle.rva_conv_epilogue.argtypes = [i, p, p, p, p, i64, i64, i, i, i, i, p]
            handle.rva_rel_pos_attention.argtypes = [i, *[p] * 7, *[i] * 7,
                                                     ctypes.c_float, p]
            handle.rva_cuda_error_string.argtypes = [i]
            handle.rva_cuda_error_string.restype = ctypes.c_char_p
            for fn in ("rva_row_gather", "rva_decode_v8_levels", "rva_fused_stem",
                       "rva_letterbox", "rva_nms_keep", "rva_nms_keep_boxes",
                       "rva_conv_epilogue", "rva_rel_pos_attention"):
                getattr(handle, fn).restype = i
            _lib = handle
    return _lib


def entry(name: str):
    """The bound C function ``name`` of the library, argument types set. A
    wrapper keeps what this returns, so that a launch pays neither the
    library lookup nor the attribute lookup."""
    return getattr(lib(), name)


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(index: int) -> int:
    """PyTorch's current stream on CUDA device ``index``, as a pointer
    value: one C call where this PyTorch has it, else through the
    ``Stream`` object."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def fail(rc: int, name: str) -> None:
    """Raise for the non-zero code ``rc`` that a launch entry returned."""
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
