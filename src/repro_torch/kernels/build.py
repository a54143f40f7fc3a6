"""Build and load the port's CUDA kernels.

Each source under ``kernels/csrc/`` (``*.cu``) is compiled by ``nvcc``
into its own shared library with a plain C interface, loaded with
``ctypes``: no PyTorch headers, so a build takes seconds, not minutes.
Libraries go into ``build/repro_torch/`` at the repository root (listed
in ``.gitignore``), named by a hash of the sources and the flags, so an
edited kernel is rebuilt and an unchanged one is loaded as it is. Each
library's nvcc output (``-Xptxas -v``: every kernel's registers, shared
memory and spills) is kept beside it, read by :func:`build_log`.

Nothing here runs at import: the CPU tests import every module of the
port on a machine with no ``nvcc`` and no card. A library is built the
first time one of its kernels is launched, or all at once, in parallel,
by :func:`build_all`. :func:`build_seconds` is the nvcc wall time this
process has spent, which the traces report as a step's ``compile_s``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("min_dist.cu", "fused_lloyd.cu", "fused_assign.cu", "lloyd.cu",
           "sensitivity.cu", "truncated.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# points per block of every kernel (csrc/common.cuh: rt::kThreads)
BLOCK_POINTS = 256

# point dtype codes of the C interface (csrc/common.cuh: rt::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_LIBS: Dict[str, ctypes.CDLL] = {}
# wall seconds of every build_all call that started an nvcc
_BUILT_S = [0.0]


def source_hash(source: str) -> str:
    """Hash of ``source``, every shared header and the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / source] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(source: str) -> Path:
    return BUILD_DIR / f"{Path(source).stem}-{source_hash(source)}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                   "bin", "nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from source on the machine with the card")


def _start(source: str) -> "tuple[subprocess.Popen, Path, Path]":
    """Start one nvcc into a temporary file beside its final path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = library_path(source)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), out


def build_all(sources: Sequence[str] = SOURCES) -> float:
    """Build every missing library, one nvcc per source, all started
    together, and wait for all of them. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    todo = [s for s in sources if not library_path(s).exists()]
    started: List[tuple] = []
    failed = []
    try:
        for s in todo:
            started.append((s, *_start(s)))
    finally:
        for s, proc, tmp, out in started:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed on {s}:\n{log}")
            else:
                out.with_suffix(".log").write_text(log)
                os.replace(tmp, out)   # atomic: a concurrent build sees
                                       # all of the library or none
    if failed:
        raise RuntimeError("\n".join(failed))
    secs = time.perf_counter() - t0
    if todo:
        _BUILT_S[0] += secs
    return secs


def build_seconds() -> float:
    """Wall seconds this process has spent building kernel libraries."""
    return _BUILT_S[0]


def build_log(source: str) -> str:
    """nvcc's output from building the library of ``source``."""
    return library_path(source).with_suffix(".log").read_text()


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if it is missing."""
    lib = _LIBS.get(source)
    if lib is None:
        if not library_path(source).exists():
            build_all([source])
        lib = ctypes.CDLL(str(library_path(source)))
        _LIBS[source] = lib
    return lib


class CudaKernel:
    """One C entry point of a kernel library, with its launch count.

    ``launches`` goes up each time the entry point is called and reports
    success, by the number of launches of the kernel that the call made
    (one, unless the caller says how many: a C loop launches one kernel
    many times). The C function launches its kernel(s) on the given
    stream and returns ``cudaGetLastError()``, and a non-zero code raises
    here. An entry point built with ``counts=other`` adds its launches to
    ``other``'s count: two C entries of one kernel keep one count.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence,
                 counts: "CudaKernel | None" = None):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._counter = self if counts is None else counts
        self._fn = None

    def __call__(self, *args, launches: int = 1) -> None:
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol} failed to launch: CUDA error {err} "
                f"({torch.cuda.get_device_name()})")
        self._counter.launches += launches


def check_on_card(name: str, points: torch.Tensor, **others) -> None:
    """Raise unless ``points`` and every other given tensor are contiguous
    CUDA tensors on one device: the kernels take raw pointers."""
    if points.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"points on {points.device}")
    for key, t in {"points": points, **others}.items():
        if t is None:
            continue
        if t.device != points.device:
            raise ValueError(f"{name}: {key} is on {t.device}, points on "
                             f"{points.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def ptr(t: "torch.Tensor | None") -> "ctypes.c_void_p | None":
    """Device pointer of a tensor as a ``c_void_p`` (None -> NULL)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"points must be float32, bfloat16 or float16, got "
                        f"{t.dtype}") from None


def blocks(n: int) -> int:
    """Blocks of BLOCK_POINTS points over ``n`` (at least 1: scratch sized
    by it is never empty)."""
    return max(-(-n // BLOCK_POINTS), 1)


def vector_f32(name: str, what: str, t: torch.Tensor, n: int
               ) -> torch.Tensor:
    """An (n,) per-point vector as the float32 the kernels read."""
    if t.shape != (n,):
        raise ValueError(f"{name}: {what} must be ({n},), got "
                         f"{tuple(t.shape)}")
    return t.to(torch.float32).contiguous()
