"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for sm_90a into its own shared library
under ``_build/`` of this package, at first use, and is bound with
``ctypes``. The library's file name carries a hash of its source and the
flags, so an edited source is never served a stale build. ``build_all``
starts one ``nvcc`` per source at once and waits for them all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Callable, List, Optional, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda/bin)")
    return path


class CudaLibrary:
    """One ``csrc/<name>.cu`` source, its build and its ctypes binding.

    ``bind(lib)`` declares ``argtypes``/``restype`` of the library's C
    entries; every entry returns ``cudaGetLastError()`` as an int."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = os.path.join(CSRC, f"{name}.cu")
        self._stem = f"libhst_{name}"
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def path(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return os.path.join(BUILD_DIR, f"{self._stem}_{digest}.so")

    def _start(self) -> Optional[Tuple[subprocess.Popen, str, str]]:
        """Start nvcc unless the library exists; (process, temp file, target)."""
        lib_path = self.path()
        if os.path.exists(lib_path):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        return proc, tmp, lib_path

    def _finish(self, started: Optional[Tuple[subprocess.Popen, str, str]]) -> str:
        if started is None:
            return self.path()
        proc, tmp, lib_path = started
        try:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source}:\n{err}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return lib_path

    def build(self) -> str:
        """Compile unless a library built from the same source exists;
        returns the library's path."""
        return self._finish(self._start())

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                self._bind(lib)
                self._lib = lib
        return self._lib


def build_all(libraries: Sequence[CudaLibrary]) -> List[str]:
    """Build every library, one nvcc process per source, all started
    together; returns the libraries' paths in order."""
    started = []
    try:
        for lib in libraries:
            started.append(lib._start())
        return [lib._finish(s) for lib, s in zip(libraries, started)]
    finally:  # a failed build stops the others rather than leaving them running
        for s in started:
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].communicate()
            if s is not None and os.path.exists(s[1]):
                os.unlink(s[1])


def check(name: str, err: int) -> None:
    """Raise on the cudaError_t a C entry returned."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
