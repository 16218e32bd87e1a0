"""Build and load the port's CUDA kernels (every ``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` at first use, all of
them at once in parallel processes, and the objects are linked into one
shared library with a plain C interface, in ``csrc/build/`` beside them (a
directory git ignores), loaded with ctypes.  The library's file name
carries a hash of every source, header (``*.cuh``) and flag, so an edited kernel never
loads a stale build; a build is published by an atomic rename, so a
concurrent process never maps a half-written file.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c"]
LINK_FLAGS = [*ARCH_FLAGS, "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
#: (restype, argtypes) of every entry point: each pointer and the stream
#: as c_void_p, so ctypes never cuts a pointer to 32 bits.
_SIGNATURES = {
    "ssf_batched_find": (_I, [_P, _LL, _P, _P, _P, _P, _I, _I, _LL, _LL, _I, _P]),
    "ssf_batched_count": (_I, [_P, _LL, _P, _P, _P, _P, _I, _I, _LL, _LL, _I, _P]),
    "ssf_memchr_find": (_I, [_P, _LL, _I, _LL, _LL, _I, _P, _P]),
    "ssf_match_bitmap": (_I, [_P, _LL, _P, _P, _P, _P, _I, _I, _LL, _LL, _I, _LL, _P]),
    "ssf_probe": (_I, [_I, _I, _P, _LL, _P, _P, _P, _P, _I, _I, _LL, _LL, _I, _P]),
    "ssf_pair_block": (_I, [_P, _P, _P, _I, _I, _P, _P, _I, _I, _P, _I, _I, _I, _I, _P, _P, _P]),
    "ssf_error_string": (ctypes.c_char_p, [_I]),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: What the build of this process did: library path, seconds spent in
#: nvcc (0.0 when an existing build was loaded) and ptxas' report.
build_info: dict = {}


def sources() -> list:
    """Every kernel source, in a fixed order."""
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def nvcc_path() -> Optional[str]:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.access(cand, os.X_OK) else None


def _library_path() -> str:
    h = hashlib.sha1(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
    for src in sources() + headers:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libssf-{h.hexdigest()[:12]}.so")


def _build(so: str) -> None:
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "CUDA kernels are built from source at first use"
        )
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = sources()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, os.path.basename(s) + ".o") for s in srcs]
        procs = [
            subprocess.Popen([nvcc, *COMPILE_FLAGS, "-o", o, s], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for s, o in zip(srcs, objs)
        ]
        reports, failed = [], []
        for s, p in zip(srcs, procs):
            try:
                out, err = p.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            reports.append(err + out)
            if p.returncode != 0:
                failed.append(f"{os.path.basename(s)} ({p.returncode}):\n{out}\n{err}")
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        tmp = os.path.join(tmpdir, "lib.so")
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp, *objs], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    build_info.update(seconds=time.perf_counter() - t0, ptxas="".join(reports))


def load() -> ctypes.CDLL:
    """The kernel library, built first if these sources have no build yet."""
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
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a kernel entry point reports a CUDA error."""
    if err != 0:
        msg = load().ssf_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
