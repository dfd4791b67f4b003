"""Build and bind the hand-written native code under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded through ``ctypes`` (no PyTorch headers, so a build
takes seconds); the host-side shard loader, ``csrc/qtz_loader.cc``, compiles
the same way with ``g++``.  Libraries are built at first use into
``csrc/_build/``, keyed on a hash of the source and the flags, and only ever
from the sources in this package.  A build writes a file named by the
process id and moves it into place with ``os.replace``, so two processes
building one library at once each load a whole file.  Nothing here runs at
import time: this module imports on a machine with no CUDA toolkit, and only
a launch on a CUDA tensor (or a native shard stream) builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # the kernels reproduce the JAX kernels' f32 rounding step by step:
    # no contraction of a*b+c into one fused multiply-add
    "--fmad=false",
    # optimize and assemble the kernels of a source in parallel: seqbeam's
    # template instantiations take a third of the time (measured on the
    # H100's host, same kernel times)
    "--split-compile=0",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
]
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _source(name: str) -> pathlib.Path:
    """``csrc/<name>.cu`` (CUDA, nvcc) or ``csrc/<name>.cc`` (host C++, g++)."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cc"


def _command(src: pathlib.Path, out: pathlib.Path) -> List[str]:
    if src.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return ["g++", *GXX_FLAGS, str(src), "-o", str(out)]


def _target(name: str) -> pathlib.Path:
    src = _source(name)
    flags = NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _own(so: pathlib.Path, suffix: str) -> pathlib.Path:
    """This process's file beside ``so``: no other process writes it."""
    return so.with_suffix(f".{os.getpid()}{suffix}")


def _start(name: str) -> subprocess.Popen | None:
    so = _target(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = open(_own(so, ".log"), "w")
    try:
        return subprocess.Popen(_command(_source(name), _own(so, ".tmp")),
                                stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()


def _finish(name: str, proc: subprocess.Popen | None) -> None:
    if proc is None:
        return
    so = _target(name)
    failed = proc.wait() != 0
    os.replace(_own(so, ".log"), so.with_suffix(".log"))
    if failed:
        src = _source(name)
        raise RuntimeError(
            f"{'nvcc' if src.suffix == '.cu' else 'g++'} failed on csrc/{src.name}:\n"
            f"{so.with_suffix('.log').read_text()}"
        )
    os.replace(_own(so, ".tmp"), so)


def build(names: Iterable[str]) -> float:
    """Build the named libraries, one compiler per source, all started
    together.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    names = list(names)
    with _lock:
        procs = [(n, _start(n)) for n in names]
        for _, p in procs:  # every nvcc ends before any failure is raised
            if p is not None:
                p.wait()
        for n, p in procs:
            _finish(n, p)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's output from the build of ``csrc/<name>`` (for a
    ``.cu``, ``-Xptxas -v``: registers, shared memory and spills per
    kernel)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.cc``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib


class CFunction:
    """One C function of a kernel library returning an int, bound at its
    first call (which builds the library if needed)."""

    def __init__(self, source: str, symbol: str, argtypes: List[type]):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self._fn = None

    def __call__(self, *args) -> int:
        if self._fn is None:
            fn = getattr(library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn(*args)


class CudaKernel(CFunction):
    """One C entry point of a kernel library, with a launch count.

    The entry point takes pointers and the stream as ``c_void_p`` and
    returns ``cudaGetLastError()`` after its launch; a nonzero code raises.
    ``launches`` counts successful launches and nothing else."""

    def __init__(self, source: str, symbol: str, argtypes: List[type]):
        super().__init__(source, symbol, argtypes)
        self.launches = 0

    def __call__(self, *args) -> None:
        err = super().__call__(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol} failed: CUDA error {err}")
        self.launches += 1
