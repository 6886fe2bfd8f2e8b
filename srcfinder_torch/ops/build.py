"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source exposes a plain C interface (``extern "C"``
functions that launch on a caller-given stream and return the
``cudaError_t`` of the launch). It is compiled by ``nvcc`` for
``sm_90a`` into a shared library under ``srcfinder_torch/_build/`` at
first use and loaded with :mod:`ctypes`; no PyTorch headers are
compiled, so a build takes seconds. The library name carries a hash of
the source and the flags, so an edited source is rebuilt and a stale
library is never loaded.

Nothing here runs at import time: the CPU-only test environment imports
every module and has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["CudaKernel", "BUILD_DIR", "build_all"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "--ptxas-options=-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA toolkit is needed to build the kernels")
    return path


class CudaKernel:
    """One CUDA source, its C entry points and its launch count.

    ``signatures`` maps each exported function name to its ctypes
    argument types (the return type is always ``int``: the launch's
    ``cudaError_t``). ``launches`` counts successful calls of
    :meth:`launch`, and ``counts`` the same per entry point; callers that
    want to attribute launches to one run :meth:`reset` them first. The
    counts are exact when several threads launch at once (the sharded
    runs of :mod:`srcfinder_torch.parallel`): each launch counts under a
    lock.
    """

    def __init__(self, source: str, signatures: dict):
        self.source = os.path.join(_CSRC, source)
        self.signatures = signatures
        self._lock = threading.Lock()
        self.reset()
        self._lib = None

    def reset(self) -> None:
        self.launches = 0
        self.counts = dict.fromkeys(self.signatures, 0)

    @property
    def name(self) -> str:
        return os.path.splitext(os.path.basename(self.source))[0]

    def lib_path(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR,
                            f"lib{self.name}-{digest.hexdigest()[:12]}.so")

    def start_build(self):
        """Start ``nvcc`` for this source unless its library exists.
        Returns ``(process, tmp_path, final_path, log_path)`` or None."""
        final = self.lib_path()
        if os.path.exists(final):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{final}.{os.getpid()}.tmp"
        log_path = final[:-3] + ".log"
        log = open(log_path, "w")
        try:
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                     self.source], stdout=log,
                                    stderr=subprocess.STDOUT)
        finally:
            log.close()
        return proc, tmp, final, log_path

    @staticmethod
    def finish_build(job) -> None:
        if job is None:
            return
        proc, tmp, final, log_path = job
        rc = proc.wait()
        if rc != 0:
            with open(log_path) as f:
                raise RuntimeError(f"nvcc failed (rc={rc}) for {final}:\n"
                                   f"{f.read()}")
        os.replace(tmp, final)

    def build_log(self) -> str:
        """nvcc's output for this source (with ``ptxas -v``: registers,
        shared memory and spills of each kernel), or "" if it was not
        built in this checkout."""
        path = self.lib_path()[:-3] + ".log"
        if not os.path.exists(path):
            return ""
        with open(path) as f:
            return f.read()

    def load(self):
        """The loaded library, built first if needed (once, whichever
        thread asks first)."""
        if self._lib is None:
            with self._lock:
                if self._lib is None:
                    self.finish_build(self.start_build())
                    lib = ctypes.CDLL(self.lib_path())
                    for fn, argtypes in self.signatures.items():
                        getattr(lib, fn).argtypes = argtypes
                        getattr(lib, fn).restype = ctypes.c_int
                    self._lib = lib
        return self._lib

    def launch(self, fn: str, *args) -> None:
        """Call the C entry point ``fn``; raise if the launch failed."""
        rc = getattr(self.load(), fn)(*args)
        if rc != 0:
            raise RuntimeError(f"{fn}: CUDA launch failed with error {rc}")
        with self._lock:
            self.launches += 1
            self.counts[fn] += 1


def build_all(kernels) -> None:
    """Build every kernel's library with one ``nvcc`` process per
    source, all started together, then load each."""
    jobs = [k.start_build() for k in kernels]
    for job in jobs:
        CudaKernel.finish_build(job)
    for k in kernels:
        k.load()
