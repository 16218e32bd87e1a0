"""grep CLI — the examples/grep.rs analogue, the port's counterpart of
``sliceslice_tpu/cli.py``.

Usage::

    python -m sliceslice_tpu_torch.cli <backend> <needle> <file> [more files...]

The backend selects the searcher by string, as the reference's
``search_in_slice`` dispatch does (examples/grep.rs:12-40; an invalid
backend is an error): ``dynamic`` (length dispatch), ``cuda`` (the kernel
searcher, the JAX package's ``pallas``), ``torch`` (plain torch ops, its
``xla``), ``naive`` (oracle), ``memchr`` (1-byte needles), ``batched``
(the needle argument is a comma-separated list), ``count`` (grep -c
analogue: overlapping occurrence counts of a list) and ``positions``
(grep -b analogue: every overlapping match offset of a list).  In
multi-needle lists ``\\,`` escapes a literal comma and ``\\\\`` a literal
backslash (see :func:`split_needles`).  The JAX package's ``stream*`` and
``sharded*`` backends and its ``--mesh`` flag are not ported yet: they are
a usage error.

The file is memory-mapped and laid out on the card once; the output is the
match verdict plus the first-match offset (a superset of the reference's
bool print).  The command line always runs on the card; :func:`main` and
:func:`make_searcher` take ``device="cpu"`` from a caller that asks.
"""

from __future__ import annotations

import sys

from .models import (
    BatchedSearcher,
    CudaSearcher,
    DynamicSearcher,
    MemchrSearcher,
    NaiveSearcher,
    TorchSearcher,
)
from .models.huge import PREFIX_LEN
from .needle import MAX_NEEDLE_LEN, needed_halo, needed_halo_for_t
from .utils.io import load_haystack

BACKENDS = {
    "dynamic": DynamicSearcher,
    "cuda": CudaSearcher,
    "torch": TorchSearcher,
    "naive": NaiveSearcher,
    "memchr": MemchrSearcher,
}

MULTI_BACKENDS = ("count", "batched", "positions")

#: The JAX package's backends that wait for a later part of the port, with
#: the ROADMAP queue 1 item that brings each.
NOT_PORTED = {
    **dict.fromkeys(("stream", "stream-count", "stream-positions"),
                    "streaming comes with ROADMAP queue 1 item 14"),
    **dict.fromkeys(("sharded", "sharded-count", "sharded-positions"),
                    "sharded corpora come with ROADMAP queue 1 item 15"),
}
MESH_NOT_PORTED = "--mesh (sharded corpora) comes with ROADMAP queue 1 item 15"

USAGE = "usage: python -m sliceslice_tpu_torch.cli <backend> <needle> <file>..."


def split_needles(arg: bytes) -> list:
    """Split a multi-needle CLI argument on commas, honoring backslash
    escapes: ``\\,`` is a literal comma, ``\\\\`` a literal backslash."""
    needles = []
    cur = bytearray()
    i = 0
    n = len(arg)
    while i < n:
        c = arg[i : i + 1]
        if c == b"\\" and i + 1 < n and arg[i + 1 : i + 2] in (b",", b"\\"):
            cur += arg[i + 1 : i + 2]
            i += 2
            continue
        if c == b",":
            needles.append(bytes(cur))
            cur = bytearray()
        else:
            cur += c
        i += 1
    needles.append(bytes(cur))
    return needles


def make_searcher(backend: str, needle: bytes, *, device="cuda"):
    """Build the backend's searcher once, for every file argument (the
    library's preprocess-once contract applied to the CLI itself)."""
    if backend in MULTI_BACKENDS:
        return BatchedSearcher(split_needles(needle), device=device)
    if backend in NOT_PORTED:
        raise SystemExit(f"backend {backend!r} is not ported yet: {NOT_PORTED[backend]}")
    cls = BACKENDS.get(backend)
    if cls is None:
        raise SystemExit(
            f"unknown backend {backend!r}; choose from "
            f"{sorted(BACKENDS) + sorted(MULTI_BACKENDS)}"
        )
    return cls(needle, device=device)


def _load_for(searcher, backend: str, path: str, *, device="cuda"):
    """The file's layout with the halo the searcher will need (sized from
    its bucketed probe widths and, for a batch, its huge needles' 64-byte
    prefix filter), so that no search re-lays it."""
    if backend in MULTI_BACKENDS:
        kh = needed_halo_for_t(searcher.max_t)
        if searcher._huge:
            kh = max(kh, PREFIX_LEN - 1)
    else:
        k = searcher.size
        kh = needed_halo(min(k, MAX_NEEDLE_LEN)) if k else 4
    return load_haystack(path, kh=max(kh, 4), device=device)


def run_on_file(searcher, backend: str, path: str, *, device="cuda"):
    """Returns (found, offset), or a per-needle list of them for the
    multi-needle backends, grep-style."""
    dh = _load_for(searcher, backend, path, device=device)
    if backend == "count":
        return [(int(c) > 0, int(c)) for c in searcher.count_all(dh)]
    if backend == "batched":
        return [(o >= 0, None if o < 0 else int(o)) for o in searcher.find_all(dh)]
    if backend == "positions":
        return [(p.size > 0, p) for p in searcher.positions_all(dh)]
    off = searcher.find(dh)
    return off is not None, off


def search_in_file(backend: str, needle: bytes, path: str, *, device="cuda"):
    """One-shot convenience: build and run (prefer make_searcher and
    run_on_file when scanning many files)."""
    return run_on_file(make_searcher(backend, needle, device=device), backend, path, device=device)


def main(argv=None, *, device="cuda"):
    argv = list(sys.argv[1:] if argv is None else argv)
    if any(a == "--mesh" or a.startswith("--mesh=") for a in argv):
        why = MESH_NOT_PORTED
    else:
        why = NOT_PORTED.get(argv[0]) if argv else None
    if why or len(argv) < 3:
        print(USAGE + (f"\n{why}" if why else ""), file=sys.stderr)
        return 2
    backend, needle, *files = argv
    needle_b = needle.encode("utf-8")
    searcher = make_searcher(backend, needle_b, device=device)  # once, for every file
    rc = 1
    for path in files:
        res = run_on_file(searcher, backend, path, device=device)
        if backend == "count":
            for nd, (found, c) in zip(split_needles(needle_b), res):
                print(f"{path}: {nd.decode('utf-8', 'replace')}: {c}")
                rc = 0 if found else rc
        elif backend == "positions":
            for nd, (found, pos) in zip(split_needles(needle_b), res):
                shown = ",".join(map(str, pos[:100].tolist()))
                more = f" (+{pos.size - 100} more)" if pos.size > 100 else ""
                print(
                    f"{path}: {nd.decode('utf-8', 'replace')}: "
                    f"{shown if found else 'no match'}{more}"
                )
                rc = 0 if found else rc
        elif backend == "batched":
            for nd, (found, off) in zip(split_needles(needle_b), res):
                print(f"{path}: {nd.decode('utf-8', 'replace')}: "
                      f"{'match at ' + str(off) if found else 'no match'}")
                rc = 0 if found else rc
        else:
            found, off = res
            print(f"{path}: {'match at ' + str(off) if found else 'no match'}")
            rc = 0 if found else rc
    return rc


if __name__ == "__main__":
    sys.exit(main())
