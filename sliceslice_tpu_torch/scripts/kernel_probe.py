"""Ablation harness of the port's find and count loop — the counterpart of
the JAX package's ``scripts/kernel_probe.py``.

The JAX script strips its TPU find kernel one piece at a time to find which
piece costs time.  This one does the same for the loop the port's find,
count and match-bitmap kernels run (``csrc/queue.cuh``: a persistent grid
over a chunk-major work queue, ``probe_wide``'s 16 positions per thread,
tables of up to 4 slots in registers; count's and the bitmap's
``group_loop``, whose items group up to 8 rows that share each corpus tile
and its slot-0 windows), through one
CUDA source with one kernel instantiation per variant (``csrc/probe.cu``).
Every variant but ``span`` and ``word`` runs on the count kernel's queue
(``scan_kernel.plan_queue`` with ``COUNT_CHUNK``); those two keep the first
design's one-block-per-(row, span) plan (``scan_kernel.plan_spans``).  Each
variant asks the question of one JAX variant, or one only this loop has:

============  ==========  ==================================================
variant       JAX         result (equals) and what it strips or changes
============  ==========  ==================================================
count         (baseline)  ``batched_count``: the count kernel's loop itself,
                          at the rows per item its plan takes
first         full        ``batched_find`` (the probes, per-thread and block
                          min, ``atomicMin``; no skip, no early exit)
nomin         nomin       1 where ``batched_find`` finds the row, else 0
                          (the probes, an OR, one flag)
noprobe       noprobe     positions below the row's limit whose 4-byte
                          window is all ones (``probe_wide``'s loads, the
                          table replaced by a constant)
empty         empty       XOR of the word indices below the row's limit
                          (the queue draw, the barriers and the address
                          math, no corpus load)
nomask        premask     ``batched_count`` (no AND on all-ones slots)
branchless    premsel     ``batched_count`` (selects, no early exit)
rows          dedup       ``batched_count`` (``rows`` rows of one chunk per
                          item share each 16-byte load)
smemtab       swpipe      ``batched_count`` (the inverse question: ``count``
                          holds tables of up to 4 slots in registers, this
                          one reads the table from shared memory at any
                          width, as wider tables are)
span          —           ``batched_count`` (``probe_wide`` on the span
                          plan, no queue: what the queue buys)
word          —           ``batched_count`` (the first design: 4 positions
                          per thread, shared-memory table, span plan)
prefilter     —           ``batched_count`` (a ``__vcmpeq4`` test of the
                          needle's first and last bytes before the slot
                          walk, which runs only on candidates)
============  ==========  ==================================================

:func:`probe` launches the kernel for a CUDA haystack (counting
``launches.probe``, :mod:`..utils.tracing`) and runs :func:`probe_plain`
for a CPU one; :func:`make_tables` builds the JAX script's tables.  Run it
as::

    python -m sliceslice_tpu_torch.scripts.kernel_probe [t=K] [r=N] [k=SWEEPS] [n=ROWS] [device=D] [variant ...]

over ``data/i386.txt`` (default t=2, r=4, 32 sweeps, 4,585 rows, variants
``count first nomin noprobe empty``; ``all`` names every variant): per variant, ms per sweep and ns per (row, 1,024 positions), on
the card (``device=cuda``, the default; it raises on a host without one)
or, with ``device=cpu``, with the plain versions on the CPU (host clock;
cut ``n`` there).  ``shares [device=D]`` prints instead :func:`walk_shares`
(plain PyTorch on ``D``, no kernel of its own): the share of (warp, row,
tile) steps that enter the count kernel's exact walk under the one-slot
filter (tables of up to 4 slots) and the two-slot filter (5 to 8 slots),
for i386's words by width group and for
512 guides of 20 bytes cut from 64 MiB of i.i.d. ACGT drawn from seed 0,
beside the shares expected of random ACGT.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
import sys
from typing import Optional

import numpy as np
import torch

from ..config import SENTINEL
from ..needle import build_probe_table, needed_halo_for_t, num_probes
from ..ops import cuda_lib, scan_kernel
from ..ops.scan_math import match_counts, match_spans, packed_windows, position_limit, table_bits
from ..utils import tracing

#: Variant names, in the order of ``csrc/probe.cu``'s ``Variant`` codes.
VARIANTS = ("count", "first", "nomin", "noprobe", "empty", "nomask", "branchless",
            "rows", "smemtab", "span", "word", "prefilter")
#: Variants whose result equals ``batched_count``.
COUNTING = ("count", "nomask", "branchless", "rows", "smemtab", "span", "word", "prefilter")
#: Positions of one warp's share of a wide tile (32 lanes of 16).
WARP_SPAN = 512
#: Variants on the first design's plan, one block per (row, span); every
#: other variant takes items from the count kernel's work queue.
SPAN_PLAN = ("span", "word")
#: Rows per queue item the ``rows`` variant takes.
ROWS = (1, 2, 4, 8)

#: The JAX script's table plan: rows per block, the final slot's mask
#: classes (k % 4 = 1, 2, 3, 0) and, for t=2, the rows planted with the
#: 8 corpus bytes at an offset (``scripts/kernel_probe.py:285-301``).
NBLK = 256
MASK_CLASSES = np.array([0xFF, 0xFFFF, 0xFFFFFF, 0xFFFFFFFF], np.uint32)
PLANTS = ((0, 100_000), (201, 40_000), (255, 700_000), (4000, 856_000))


def make_tables(hay: bytes, t: int, n: int = 4585, seed: int = 0):
    """uint32 ``(values, masks)`` of ``n`` rows padded to a multiple of
    256, drawn as the JAX script draws them: values 1..6, full masks but
    for the final slot's four classes in turn, and for t=2 the rows of
    :data:`PLANTS` holding corpus bytes (where the corpus has them)."""
    n_pad = -(-n // NBLK) * NBLK
    rng = np.random.default_rng(seed)
    values = rng.integers(1, 7, (n_pad, t), dtype=np.uint32).astype(np.uint32)
    masks = np.full((n_pad, t), 0xFFFFFFFF, np.uint32)
    masks[:, t - 1] = MASK_CLASSES[np.arange(n_pad) % 4]
    values = (values & masks).astype(np.uint32)
    if t == 2:
        for row, off in PLANTS:
            if row < n_pad and off + 8 <= len(hay):
                v0, v1 = struct.unpack("<II", hay[off : off + 8])
                values[row] = (v0, v1 & masks[row, 1])
    return values, masks


def needle_lengths(masks: np.ndarray) -> np.ndarray:
    """int64[N]: the needle length each row's table describes: 4 bytes per
    slot but the last, plus the last slot's mask bytes."""
    last = np.asarray(masks, np.uint32)[:, -1].astype(np.int64)
    nbytes = sum(((last >> (8 * b)) & 0xFF) != 0 for b in range(4))
    return 4 * (masks.shape[1] - 1) + nbytes


def table_ends(masks: np.ndarray, length: int) -> np.ndarray:
    """int32[N] ends ``length - k + 1`` of each row (0 when it is longer
    than the corpus): no position lets the needle run into the zero halo."""
    return np.maximum(length - needle_lengths(masks) + 1, 0).astype(np.int32)


def planted(hay: bytes, masks: np.ndarray) -> dict:
    """{row: needle bytes} of the t=2 rows :func:`make_tables` planted."""
    k = needle_lengths(masks)
    return {row: hay[off : off + int(k[row])] for row, off in PLANTS
            if row < masks.shape[0] and off + 8 <= len(hay)}


def warp_steps(ends, nbytes: int, t: int, n_real: Optional[int] = None) -> int:
    """The (warp, wide tile) steps of rows below ``n_real`` of a width-``t``
    table over an ``nbytes`` layout (base 0): per row, the warps' spans of
    :data:`WARP_SPAN` positions that hold a position below its limit."""
    ends = np.asarray(ends, np.int64)[: len(ends) if n_real is None else n_real]
    limits = np.clip(ends, 0, position_limit(nbytes, t))
    return int((-(-limits // WARP_SPAN)).sum())


def _check(variant: str, rows: int) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown probe variant {variant!r} (one of {', '.join(VARIANTS)})")
    if variant == "rows" and rows not in ROWS:
        raise ValueError(f"rows takes {ROWS} rows per block, got {rows}")


def probe_plain(variant, hay, values, masks, ends, base=0, n_real=None, rows=4) -> torch.Tensor:
    """Plain PyTorch version of :func:`probe` (same signature and answers),
    built on ``ops/scan_math.py``."""
    base, values, masks, ends = scan_kernel._operands(hay, values, masks, ends, base)
    n, t = values.shape
    _check(variant, rows)
    n_real = scan_kernel._n_real(n_real, n)
    if variant == "first":
        return scan_kernel.batched_find_plain(hay, values, masks, ends, base, n_real)
    if variant == "nomin":
        found = scan_kernel.batched_find_plain(hay, values, masks, ends, base, n_real)
        return (found != SENTINEL).to(torch.int32)
    out = torch.zeros((n,), dtype=torch.int32, device=hay.device)
    if n_real == 0:
        return out
    bound = position_limit(hay.numel(), t)
    limits = (ends[:n_real].to(torch.int64) - base).clamp(min=0, max=bound)
    if variant == "noprobe":
        hits = torch.nonzero(packed_windows(hay[: bound + 3]) == -1).flatten()
        out[:n_real] = torch.searchsorted(hits, limits).to(torch.int32)
    elif variant == "empty":
        last = (limits + 3) // 4 - 1  # the last word index visited, -1 for none
        xor_upto = torch.stack([last, torch.ones_like(last), last + 1, torch.zeros_like(last)])
        x = xor_upto.gather(0, (last % 4)[None, :])[0]
        out[:n_real] = torch.where(last >= 0, x, 0).to(torch.int32)
    else:
        out[:n_real] = match_counts(hay, values[:n_real], masks[:n_real], limits).to(torch.int32)
    return out


@functools.lru_cache(maxsize=128)
def _resident_blocks(index: int, code: int, per_item: int, t_class: int) -> int:
    """Blocks of a queue variant's kernel that CUDA device ``index`` holds
    at once (blocks per SM times SMs)."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = cuda_lib.load().ssf_probe_blocks(code, per_item, t_class, ctypes.byref(per_sm))
    cuda_lib.check(err, "ssf_probe_blocks")
    return per_sm.value * scan_kernel._sm_count(index)


def probe(variant, hay, values, masks, ends, base=0, n_real=None, rows=4) -> torch.Tensor:
    """int32[N]: one ablation variant of the count loop over the flat
    haystack ``hay``, with the operands of ``scan_kernel.batched_count``;
    ``rows`` is the rows per queue item of the ``rows`` variant.  The module
    docstring gives each variant's result; rows at or past ``n_real`` hold
    what an unscanned row holds (0, SENTINEL for ``first``)."""
    if hay.device.type == "cpu":
        return probe_plain(variant, hay, values, masks, ends, base, n_real, rows)
    if hay.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {hay.device}")
    base, values, masks, ends = scan_kernel._operands(hay, values, masks, ends, base)
    n, t = values.shape
    _check(variant, rows)
    n_real = scan_kernel._n_real(n_real, n)
    fill = SENTINEL if variant == "first" else 0
    out = torch.full((n,), fill, dtype=torch.int32, device=hay.device)
    values, masks, ends = values.contiguous(), masks.contiguous(), ends.contiguous()
    scan_kernel._cuda_ready(hay, values, masks, ends)
    n_pos = position_limit(hay.numel(), t)
    if n_real == 0 or n_pos <= 0:
        return out
    code = VARIANTS.index(variant)
    per_item = rows if variant == "rows" else 1
    index = hay.device.index
    queue = None
    if variant in SPAN_PLAN:
        tile = scan_kernel.WIDE_TILE if variant == "span" else scan_kernel.FIND_TILE
        step, n_steps = scan_kernel.plan_spans(n_pos, n_real, tile, scan_kernel._sm_count(index))
        grid = 0
    else:
        t_class = min(t, scan_kernel.MAX_GROUP_T + 1)

        def resident(group: int) -> int:
            return _resident_blocks(index, code, group, t_class)

        if variant == "count":  # the count kernel's plan, at its rows per item
            plan = scan_kernel.plan_grouped(hay.numel(), t, n_real, scan_kernel.COUNT_CHUNK, resident)
        else:
            plan = scan_kernel.plan_queue(hay.numel(), t, n_real, resident(per_item),
                                          scan_kernel.COUNT_CHUNK, per_item)
        step, n_steps, grid, per_item = plan.chunk, plan.n_items, plan.grid, plan.group
        queue = torch.zeros((1,), dtype=torch.int32, device=hay.device)
    with torch.cuda.device(hay.device):
        err = cuda_lib.load().ssf_probe(
            code, per_item, hay.data_ptr(), hay.numel() // 4, n_pos, values.data_ptr(),
            masks.data_ptr(), ends.data_ptr(), out.data_ptr(), n_real, t, base, step, n_steps,
            grid, None if queue is None else queue.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(err, f"ssf_probe({variant})")
    tracing.count("launches.probe")
    return out


def walk_shares(hay: bytes, needles, device) -> list:
    """``[(t, rows, steps, walk1, walk2)]``: for each width group of
    ``needles`` over ``hay`` (tables as ``BatchedSearcher`` builds them),
    its (warp, row, tile) steps and how many of them the one-slot and the
    two-slot filter pass: :func:`..ops.scan_math.match_spans` of slot 0
    and of slots 0 and 1 over the warps' spans of :data:`WARP_SPAN`
    positions, on ``device``."""
    from ..ops.layout import preprocess

    widths = sorted({num_probes(len(nd)) for nd in needles})
    dh = preprocess(hay, kh=needed_halo_for_t(widths[-1]), device=device)
    out = []
    for t in widths:
        group = [nd for nd in needles if num_probes(len(nd)) == t]
        values, masks, lens = build_probe_table(group, t_max=t)
        ends = np.maximum(len(hay) - lens + 1, 0)
        n_pos = dh.flat.numel()
        limits = torch.from_numpy(np.clip(ends, 0, position_limit(n_pos, t))).to(dh.flat.device)
        v, m = table_bits(values, dh.flat.device), table_bits(masks, dh.flat.device)
        walks = [int(match_spans(dh.flat, v[:, :s], m[:, :s], limits, WARP_SPAN).sum())
                 for s in (1, min(2, t))]
        out.append((t, len(group), warp_steps(ends, n_pos, t), *walks))
    return out


def _print_shares(name: str, rows: list) -> None:
    for t, n, steps, w1, w2 in rows + [("all", *np.sum([r[1:] for r in rows], axis=0))]:
        print(f"{name} t={t}: {int(n)} rows, {int(steps)} steps; exact walk under one slot "
              f"{100 * w1 / max(steps, 1):.4f}%, under two slots {100 * w2 / max(steps, 1):.4f}%")


def main_shares(device) -> int:
    """``shares``: :func:`walk_shares` of i386's words and of 512 guides of
    20 bytes cut from 64 MiB of i.i.d. ACGT drawn from seed 0."""
    from ..utils.profiling import card

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    where = card(device.index) if device.type == "cuda" else "CPU, plain versions"
    print(f"{where}; exact-walk shares of (warp, row, tile) steps, {WARP_SPAN} positions a warp")
    with open(os.path.join(repo, "data", "i386.txt"), "rb") as f:
        hay = f.read()
    with open(os.path.join(repo, "data", "words.txt"), "rb") as f:
        words = [w for w in f.read().split(b"\n") if w]
    _print_shares("i386 words", walk_shares(hay, words, device))
    rng = np.random.default_rng(0)
    dna = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 64 << 20)].tobytes()
    at = rng.choice(len(dna) - 20, 512, replace=False)
    _print_shares("ACGT 64 MiB, 512 guides", walk_shares(dna, [dna[a : a + 20] for a in at], device))
    print(f"random ACGT, expected: one slot {100 * (1 - (1 - 4.0**-4) ** WARP_SPAN):.4f}%, "
          f"two slots {100 * (1 - (1 - 4.0**-8) ** WARP_SPAN):.4f}%")
    return 0


def main(argv: Optional[list] = None) -> int:
    from ..ops.layout import preprocess, resolve_device
    from ..utils.profiling import card, measure

    opts = {"t": 2, "r": 4, "k": 32, "n": 4585}
    device = "cuda"
    variants = []
    for a in sys.argv[1:] if argv is None else argv:
        key, eq, val = a.partition("=")
        if eq and key in opts:
            opts[key] = int(val)
        elif eq and key == "device":
            device = val
        else:
            variants.append(a)
    t, rows, sweeps, n = opts["t"], opts["r"], opts["k"], opts["n"]
    if variants == ["shares"]:
        return main_shares(resolve_device(device))
    if "all" in variants:
        variants = list(VARIANTS)
    variants = variants or ["count", "first", "nomin", "noprobe", "empty"]
    for v in variants:
        _check(v, rows)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    hay = open(os.path.join(repo, "data", "i386.txt"), "rb").read()
    device = resolve_device(device)
    dh = preprocess(hay, kh=needed_halo_for_t(t), device=device)
    values, masks = make_tables(hay, t, n)
    ends = table_ends(masks, len(hay))
    where = card(device.index) if device.type == "cuda" else "CPU, plain versions, host clock"
    print(f"{where}; t={t}, {n} rows over {len(hay)} bytes, {sweeps} sweeps per sample")
    tiles = n * len(hay) / 1024
    for v in variants:
        out = probe(v, dh.flat, values, masks, ends, n_real=n, rows=rows)
        same = ""
        if device.type == "cuda":
            plain = probe_plain(v, dh.flat, values, masks, ends, n_real=n, rows=rows)
            same = f"  equals plain: {torch.equal(out, plain)}"

        def run():
            for _ in range(sweeps):
                probe(v, dh.flat, values, masks, ends, n_real=n, rows=rows)

        m = measure(run, v, warmup=1, samples=3 if device.type == "cuda" else 1, device=device)
        per = m.estimate / sweeps
        print(f"{v:10s}: {per * 1e3:8.4f} ms/sweep  {per * 1e9 / tiles:7.3f} ns/(row, 1024 pos)  "
              f"nonzero rows {int((out[:n] != (SENTINEL if v == 'first' else 0)).sum())}{same}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
