"""Build and load the port's CUDA kernels (``csrc/find.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use, into ``csrc/build/`` beside it (a
directory git ignores), and loaded with ctypes.  The library's file name
carries a hash of the source, so an edited kernel never loads a stale
build; a build is published by an atomic rename, so a concurrent process
never maps a half-written file.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCE = os.path.join(_CSRC, "find.cu")
BUILD_DIR = os.path.join(_CSRC, "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: What the build of this process did: library path, seconds spent in
#: nvcc (0.0 when an existing build was loaded) and ptxas' report.
build_info: dict = {}


def nvcc_path() -> Optional[str]:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.access(cand, os.X_OK) else None


def _library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libssf_find-{digest}.so")


def _build(so: str) -> None:
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "CUDA kernels are built from source at first use"
        )
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True, text=True, timeout=600,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    build_info.update(seconds=seconds, ptxas=proc.stderr + proc.stdout)


def load() -> ctypes.CDLL:
    """The kernel library, built first if this source has no build yet."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _library_path()
        if not os.path.exists(so):
            _build(so)
        else:
            build_info.update(seconds=0.0, ptxas="")
        build_info["library"] = so
        lib = ctypes.CDLL(so)
        lib.ssf_batched_find.restype = ctypes.c_int
        lib.ssf_batched_find.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.ssf_memchr_find.restype = ctypes.c_int
        lib.ssf_memchr_find.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ssf_error_string.restype = ctypes.c_char_p
        lib.ssf_error_string.argtypes = [ctypes.c_int]
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a kernel entry point reports a CUDA error."""
    if err != 0:
        msg = load().ssf_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
