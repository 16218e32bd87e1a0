"""ctypes bindings for the native SWAR scanner (the port's own
``csrc/host/swarscan.cpp`` and ``csrc/host/twoway.cpp``): the host rung of
``DynamicSearcher`` for tiny haystacks, the match-bitmap decoder of the
positions path, and the host tiers of huge needles.

A copy of the JAX package's loader over the port's copy of its sources:
compiled on first use with the system toolchain (g++ -O3 -march=native)
into the port's ``csrc/build/`` and loaded with ctypes, so the two packages
never share a source or a built file.  This is host C++, not device code.
Everything degrades to the pure-Python oracle when no toolchain is
available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SRCS = [os.path.join(_CSRC, "host", "swarscan.cpp"), os.path.join(_CSRC, "host", "twoway.cpp")]


def _host_tag() -> str:
    """Fingerprint of this host's ISA extensions: the cache is compiled
    with -march=native, so a .so that traveled with the working tree to a
    different CPU must MISS and rebuild — dlopen checks only ELF arch, and
    a stale cache would SIGILL at the first call."""
    import hashlib

    data = b""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags") or line.startswith(b"Features"):
                    data = line
                    break
    except OSError:
        pass
    if not data:
        import platform

        data = (platform.machine() + platform.processor()).encode()
    return hashlib.sha1(data).hexdigest()[:10]


_lib = None
_tried = False


def _so_path() -> str:
    return os.path.join(_CSRC, "build", f"libswarscan-{_host_tag()}.so")


def _build(so: str) -> Optional[str]:
    try:
        os.makedirs(os.path.dirname(so), exist_ok=True)
        cached = os.path.exists(so) and all(
            os.path.getmtime(so) >= os.path.getmtime(src) for src in _SRCS
        )
    except OSError:
        # Read-only install / missing sources: the documented degradation
        # is pure-Python, never an exception from the search path.
        return None
    if cached:
        return so
    # Atomic publish: compile to a private temp path, then rename — a
    # concurrent process can never dlopen a half-written ELF.
    tmp = f"{so}.tmp.{os.getpid()}"
    for cxx in ("g++", "clang++", "c++"):
        try:
            subprocess.run(
                [cxx, "-O3", "-march=native", "-shared", "-fPIC", *_SRCS, "-o", tmp],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so)
            return so
        except (OSError, subprocess.CalledProcessError):
            try:
                os.remove(tmp)
            except OSError:
                pass
            continue
    return None


def load() -> Optional[ctypes.CDLL]:
    """The compiled library, or None when unavailable (no toolchain)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _so_path()
    so = _build(path)
    if so is None:
        return None
    try:
        _lib = _bind(ctypes.CDLL(so))
    except OSError:
        # Corrupt or ISA-incompatible cached .so: degrade, don't crash the
        # search path.
        return None
    except AttributeError:
        # A stale cached .so from an older source can lack newer symbols:
        # force one rebuild, then degrade to None.
        try:
            os.remove(path)
        except OSError:
            return None
        so = _build(path)
        if so is None:
            return None
        try:
            _lib = _bind(ctypes.CDLL(so))
        except (OSError, AttributeError):
            return None
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.swar_find_pos.restype = ctypes.c_int64
    lib.swar_find_pos.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.swar_find_batch.restype = None
    lib.swar_find_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, np.ctypeslib.ndpointer(np.int64),
        ctypes.c_int64, np.ctypeslib.ndpointer(np.int64),
    ]
    lib.swar_pairwise.restype = None
    lib.swar_pairwise.argtypes = [
        ctypes.c_char_p, np.ctypeslib.ndpointer(np.int64), ctypes.c_int64, np.ctypeslib.ndpointer(np.int8),
    ]
    lib.twoway_find.restype = ctypes.c_int64
    lib.twoway_find.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    lib.twoway_find_batch.restype = None
    lib.twoway_find_batch.argtypes = lib.swar_find_batch.argtypes
    lib.decode_bitmap_count.restype = ctypes.c_int64
    lib.decode_bitmap_count.argtypes = [np.ctypeslib.ndpointer(np.uint32), ctypes.c_int64]
    lib.decode_bitmap.restype = ctypes.c_int64
    lib.decode_bitmap.argtypes = [
        np.ctypeslib.ndpointer(np.uint32), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,
    ]
    return lib


def available() -> bool:
    return load() is not None


def swar_find(hay: bytes, needle: bytes, position: Optional[int] = None) -> Optional[int]:
    lib = _need()
    pos = len(needle) - 1 if position is None else position
    r = lib.swar_find_pos(hay, len(hay), needle, len(needle), pos)
    return None if r < 0 else int(r)


def _need() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError("native swarscan unavailable (no C++ toolchain)")
    return lib


def _pack(needles: Sequence[bytes]):
    offsets = np.zeros(len(needles) + 1, dtype=np.int64)
    for i, nd in enumerate(needles):
        offsets[i + 1] = offsets[i] + len(nd)
    return b"".join(needles), offsets


def swar_find_batch(hay: bytes, needles: Sequence[bytes]) -> np.ndarray:
    """First offset of each needle (int64, -1 absent) by the SWAR scanner:
    the same-host competitor row of the benchmarks."""
    flat, offsets = _pack(needles)
    out = np.empty(len(needles), dtype=np.int64)
    _need().swar_find_batch(hay, len(hay), flat, offsets, len(needles), out)
    return out


def twoway_find(hay: bytes, needle: bytes) -> Optional[int]:
    """First occurrence by the from-scratch Two-Way scanner
    (``csrc/host/twoway.cpp``), the reference's twoway/memmem competitor."""
    r = _need().twoway_find(hay, len(hay), needle, len(needle))
    return None if r < 0 else int(r)


def twoway_find_batch(hay: bytes, needles: Sequence[bytes]) -> np.ndarray:
    flat, offsets = _pack(needles)
    out = np.empty(len(needles), dtype=np.int64)
    _need().twoway_find_batch(hay, len(hay), flat, offsets, len(needles), out)
    return out


def swar_pairwise(words: Sequence[bytes]) -> np.ndarray:
    """bool[N, N]: word ``i`` occurs in word ``j``, by the SWAR scanner."""
    flat, offsets = _pack(words)
    out = np.empty((len(words), len(words)), dtype=np.int8)
    _need().swar_pairwise(flat, offsets, len(words), out)
    return out.astype(bool)


def decode_bitmap(words: np.ndarray) -> Optional[np.ndarray]:
    """Native decode of one linear match bitmap (bit ``b`` of word ``w``
    marks position ``32w + b``; uint32 words or their int32 bit patterns)
    to ascending int64 positions, or None when the toolchain is missing.
    The decoder's ``(g, q, lanes)`` layout with ``g = lanes = 1``, ``q =
    len(words)`` and ``s = 32 q`` is the linear one, walked in order."""
    lib = load()
    if lib is None:
        return None
    w = np.ascontiguousarray(np.asarray(words).view(np.uint32).reshape(-1))
    m = int(lib.decode_bitmap_count(w, w.size))
    out = np.empty(m, dtype=np.int64)
    if int(lib.decode_bitmap(w, 1, w.size, 1, 32 * w.size, out, m)) != m:
        return None
    return out
