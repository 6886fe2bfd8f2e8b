"""Build and bind the port's hand-written native code.

Each ``csrc/*.cu`` source exposes a plain C interface (``extern "C"``
functions that launch on a caller-given stream and return the
``cudaError_t`` of the launch). It is compiled by ``nvcc`` for
``sm_90a`` into a shared library under ``srcfinder_torch/_build/`` at
first use and loaded with :mod:`ctypes`; no PyTorch headers are
compiled, so a build takes seconds. ``csrc/native.cpp``, the host
runtime, is compiled the same way by the host's C++ compiler
(:class:`HostLibrary`). A library's name carries a hash of its source
and flags, so an edited source is rebuilt and a stale library is never
loaded. Each build writes a file of its own and renames it into place,
so processes that build at once (test workers) never load a partial
library.

Nothing here runs at import time, and nothing imports torch: the CPU-only
test environment imports every module and has no ``nvcc``, and the host
runtime serves processes that never load torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["CudaKernel", "HostLibrary", "BUILD_DIR", "build_all"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "--ptxas-options=-v")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


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


def _cxx() -> str:
    found = shutil.which("c++")
    if not found:
        raise RuntimeError("no host C++ compiler (c++) on PATH; it is needed "
                           "to build the port's host runtime")
    return found


class _Library:
    """One source compiled into a shared library at first use and loaded
    with ctypes. Subclasses give the compiler and flags (``flags``,
    ``_compiler``) and bind the entry points (``_bind``)."""

    flags: tuple = ()

    def __init__(self, source: str, signatures: dict):
        self.source = os.path.join(_CSRC, source)
        self.signatures = signatures
        self._lock = threading.Lock()
        self._lib = None

    @staticmethod
    def _compiler() -> str:
        raise NotImplementedError

    def _bind(self, lib) -> None:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return os.path.splitext(os.path.basename(self.source))[0]

    def lib_path(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha1(f.read() + " ".join(self.flags).encode())
        return os.path.join(BUILD_DIR,
                            f"lib{self.name}-{digest.hexdigest()[:12]}.so")

    def start_build(self):
        """Start the compiler for this source unless its library exists.
        Returns ``(process, tmp_path, final_path, log_path)`` or None."""
        final = self.lib_path()
        if os.path.exists(final):
            return None
        compiler = self._compiler()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{final}.{os.getpid()}.tmp"
        log_path = f"{tmp}.log"
        with open(log_path, "w") as log:
            proc = subprocess.Popen([compiler, *self.flags, "-o", tmp, self.source],
                                    stdout=log, stderr=subprocess.STDOUT)
        return proc, tmp, final, log_path

    @staticmethod
    def finish_build(job) -> None:
        if job is None:
            return
        proc, tmp, final, log_path = job
        rc = proc.wait()
        if rc != 0:
            with open(log_path) as f:
                raise RuntimeError(f"{os.path.basename(final)}: the compiler failed "
                                   f"(rc={rc}):\n{f.read()}")
        os.replace(log_path, final[:-3] + ".log")
        os.replace(tmp, final)

    def build_log(self) -> str:
        """The compiler's output for this source (for nvcc with ``ptxas
        -v``: registers, shared memory and spills of each kernel), or "" if
        it was not built in this checkout."""
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
                    self._bind(lib)
                    self._lib = lib
        return self._lib


class CudaKernel(_Library):
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

    flags = NVCC_FLAGS
    _compiler = staticmethod(_nvcc)

    def __init__(self, source: str, signatures: dict):
        super().__init__(source, signatures)
        self.reset()

    def _bind(self, lib) -> None:
        for fn, argtypes in self.signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int

    def reset(self) -> None:
        self.launches = 0
        self.counts = dict.fromkeys(self.signatures, 0)

    def launch(self, fn: str, *args) -> None:
        """Call the C entry point ``fn``; raise if the launch failed."""
        rc = getattr(self.load(), fn)(*args)
        if rc != 0:
            raise RuntimeError(f"{fn}: CUDA launch failed with error {rc}")
        with self._lock:
            self.launches += 1
            self.counts[fn] += 1


class HostLibrary(_Library):
    """One C++ source of host code, built by the host's ``c++`` (``-O3
    -std=c++17 -shared -fPIC``). ``signatures`` maps each exported
    function name to ``(restype, argtypes)``; :meth:`call` returns what
    the function returns. ctypes releases the interpreter lock for the
    length of every call, so threads run the library's functions at
    once."""

    flags = CXX_FLAGS
    _compiler = staticmethod(_cxx)

    def _bind(self, lib) -> None:
        for fn, (restype, argtypes) in self.signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype

    def call(self, fn: str, *args):
        return getattr(self.load(), fn)(*args)


def build_all(kernels) -> None:
    """Build every library with one compiler process per source, all
    started together, then load each."""
    jobs = [k.start_build() for k in kernels]
    for job in jobs:
        _Library.finish_build(job)
    for k in kernels:
        k.load()
