#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sliceslice_tpu_torch/csrc`` with
nvcc (and fails on any ptxas spill), holds each kernel against its plain
PyTorch version on the card (the find, count, match-bitmap, rank and
compaction kernels also on their work queue's hard cases: t = 1..8, 16,
32, 512, a match only in a row's last chunk, absent rows, one-row launches
over 1 MiB and 256 MiB, ends inside a 16-position group and at the
buffer's last words, ``base > 0``, ``n_real < n``, repeated launches, the
rank kernel's SENTINEL tail and the capped compaction at caps 1, 7, 64,
4096 and 16,384, the packed compaction in windows of 7, 1,000 and a third
of the offsets, a t = 128 table of chunks of differing lengths
with mask-0 padded slots and differing ends, the chained bitmap of huge
needles; the pair-block kernel on the hard cases of
``sliceslice_tpu_torch/scripts/pair_cases.py``: tiles in both directions,
lengths on the plan's buckets, needles equal to their words, empty and
1-byte needles, rows and tables longer than the kernel's unrolled loads,
unsorted lists, skipped blocks, padded rows, two launches alike), and
drives the port's main paths against host oracles:

* find: ``preprocess`` -> ``BatchedSearcher.find_all`` over all 4,585
  words of data/words.txt in the 857,425-byte data/i386.txt, then
  ``DynamicSearcher``'s arms and a seeded 256 MiB corpus, against
  ``bytes.find``;
* count: ``BatchedSearcher.count_all`` over the same words and corpus
  before and after ``optimize_for``, ``DynamicSearcher.count_in`` on every
  arm and counts in the 256 MiB corpus, against ``overlapping_count``;
* positions: ``BatchedSearcher.positions_all`` over the same words and
  corpus before and after ``optimize_for`` (rows past the sparse cap and
  under it, every row compacted on the card and no bitmap decoded on the
  host; one bitmap, one rank and one compaction launch per width group),
  ``DynamicSearcher.positions`` on every arm, a flat layout on the card
  kept without host bytes, and the 256 MiB corpus's needles, against the
  host positions oracle;
* the all-pairs sweep: ``PairwiseSearcher`` over the length-sorted words,
  all 21,022,225 pairs, against ``bytes.find``; 32 ``count_matches_device``
  calls must make 32 launches and no plan upload;
* the count and bitmap group walk of tables of 5 to 8 slots: 512 guides
  of 20 bytes and 32 each of 21 to 32 bytes over a seeded 64 MiB
  four-letter text, where slot 0 passes a window in 256, with copies
  planted whole and with a later byte changed (they pass slots 0 and 1
  and fail a later slot) and each width's needle at the text's last
  position; each width at 8 rows an item behind the two-slot filter
  (its tiled and two-slot row counters), ``batched_count`` and
  ``match_bitmap_counted`` against their plain versions, the bitmap's
  totals against the counts and sampled rows against
  ``overlapping_count``;
* the ablation harness: every variant of the probe kernel at t = 1, 2, 3
  over the JAX harness's tables (4,585 rows over i386), against its plain
  version and the count and find kernels, and the counting variants over
  the real words' tables against the count kernel;
* huge needles (over 2,048 bytes): ``DynamicSearcher`` find / count_in /
  positions of i386 needles of 2,049 to 65,536 bytes and of the 256 MiB
  corpus's of up to 1 MiB (the host-verify tier), of a period-1 corpus and
  of 20,000 records sharing one prefix (the chained-bitmap tier), each
  call on its tier with its launches, and one ``BatchedSearcher`` of all
  the words and the i386 huge needles;
* streams: ``StreamingScanner`` find (with and without early stop),
  count and positions over i386 at 64 KiB windows (all the words; prefetch
  2 and 0; file and chunks), the 256 MiB corpus written to a file (its 41
  needles at 32 MiB and 1 MiB windows; five early-stopped finds on one
  scanner, a stop mid-stream), a 4.5 GiB chunk stream with
  scripts/bigscan_check.py's plants (offsets past 2^31 and 2^32; a stream
  that starts at 2^32 - window + 64), and the words with the huge phase's
  i386 needles; GB/s per mode with the stats split; then, outside the
  stream path's counts, the card's part of one 32 MiB window (CUDA
  events), a torch.profiler trace of one stream per mode (the card's idle
  share) and the single-layout sweeps of the same needles;
* sharded corpora (``parallel/``): in an NCCL group of one, meshes 1x1,
  2x1, 4x1 and 2x2 of cells on the card, ``ShardedBatchedSearcher`` over
  i386 (all the words, before and after ``optimize_for``, the int64
  combine, needles across every shard boundary, a ``GlobalCorpus``), the
  256 MiB corpus, huge needles on both tiers, a stream over a 4x1 mesh and
  the CLI's sharded backends; then two processes under gloo over a
  4.5 GiB corpus, each holding its half as two cells
  (``scripts/multihost_check.py --device cuda``); then, outside the
  path's counts, the sharded sweeps against the single layout's, a
  collective's µs and ``measure_scaling`` over cells on the card;
* the grep CLI: ``python -m sliceslice_tpu_torch.cli`` with the dynamic,
  batched, count, positions and stream backends over data/i386.txt, a huge
  needle among the needles, seven processes at once, against bytes.find's
  lines;
* the probe-table contracts (``scripts/contract_cases.py``): the
  mixed-width table the JAX package refuses, a final mask of 0xFFFF0000
  and a prefix mask through the find, count, bitmap and compaction
  kernels, against their plain versions and the host oracles, and the
  exotic table through a 2x1 sharded sweep;
* the harness: the full conformance run (``scripts/conformance.py``: the
  4,585 words over i386 and the 21,022,225 pairs, against the oracles the
  find and pairwise phases built), the fuzz campaign
  (``scripts/fuzz_campaign.py``, 24 rounds, seed 20260818), the random size
  matrix, one ``python -m sliceslice_tpu_torch.bench`` run at full size
  (its JSON lines printed before the smoke's last lines), and
  ``breakeven``, ``oneshot_decompose`` and ``perf_long`` once each;

then times the sweeps, each kernel (the find and count kernels per width
group; the rank and compaction kernels alone and as wrapper calls, packed
and capped, beside the first design's torch ops; the pair kernel's device time in both modes; the count kernel, the
harness's ``count`` variant, which must come within 5% of it, its ``word``
variant, the first count loop, and its ``prefilter`` and ``nomask`` variants
over the real words' tables, in turns), the huge-needle tiers per call and
operation (with the host verify's share and the bitmap kernel at t = 128
against its bound) and the ablation table with CUDA events.  Every phase prints one
line and its seconds; any failure raises and exits non-zero.  The
next-to-last lines are a JSON object describing the kernels (times, bound
and what sets it, launches per sweep) and the card's name and power
limit; the last line is ``{"ok": true, "device": ...}``.  Imports nothing
of JAX.  Each main path's launches are the differences of the program's
``launches.<wrapper>`` counters (``utils/tracing.py``) from just before
it to just after; the huge-needle, stream, sharded and harness paths have
their own (``huge_path_launches``, ``stream_path_launches``,
``sharded_path_launches``, ``harness_path_launches``,
``contracts_path_launches``).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIND_SOURCE = "sliceslice_tpu_torch/csrc/find.cu"
PAIR_SOURCE = "sliceslice_tpu_torch/csrc/pairwise.cu"
PROBE_SOURCE = "sliceslice_tpu_torch/csrc/probe.cu"
POSITIONS_SOURCE = "sliceslice_tpu_torch/csrc/positions.cu"
BIG_BYTES = 256 * 1024 * 1024
SWEEPS = 32
#: Launches per timed sample of an ablation variant (12 variants at three
#: widths: the table is the longest of the timed phases).
ABLATION_SWEEPS = 8
#: positions_all sweeps per timed sample (each reads its answers back).
POSITION_SWEEPS = 4
#: The group-wide phase: its four-letter text, and its needles per width
#: (t = 5: the 20-byte guides of a dna200m-count request; t = 6..8: 21 to
#: 32 bytes), all at 8 rows an item.
GROUP_WIDE_BYTES = 64 << 20
GROUP_WIDE_ROWS = {5: 512, 6: 32, 7: 32, 8: 32}
#: Rows per width held against ``overlapping_count`` (0.2 s each on this
#: text): the planted ones, the text's last needle and a random sample.
GROUP_WIDE_ORACLE_ROWS = 12
#: Probe-table widths the ablation harness runs.
PROBE_TS = (1, 2, 3)
#: How far the ablation harness's `count` variant may lie from the count
#: kernel it is built from, as a share of the kernel's time, in turns.
HARNESS_TOLERANCE = 0.05
#: Compaction caps held against the plain version: inside a word, inside
#: an item, the default, the huge needles' host-verify budget.
CAPS = (1, 7, 64, 4096, 16384)
#: Planted only in the last 100 bytes of the 256 MiB corpus.
LAST_CHUNK_NEEDLE = b"\xfc\xfd\xfe\xfc\xfd\xfe\xfc\xfd\xfe"
#: The 256 MiB corpus's periodic run's needle (998 overlapping matches),
#: the 41st needle of its count, positions and stream checks.
BIG_PERIODIC = b"\xfa\xfb" * 3
#: The first find and count design's per-width-group kernel times over the
#: i386 sweep, in µs (traces on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md).
FIRST_DESIGN_GROUP_US = {"find": {"1": 332.5, "2": 618.2, "3": 365.1, "4..6": 124.5},
                         "count": {"1": 763.3, "2": 1468.6, "3": 781.7, "4..6": 616.0}}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def counter(name: str) -> int:
    """The program's counter ``name`` so far (``utils/tracing.py``):
    ``launches.<wrapper>``, ``uploads.pair_block``, ..."""
    from sliceslice_tpu_torch.utils import tracing

    return tracing.counters().get(name, 0)


def timed(fn, *args):
    """Run one phase and print the seconds it took."""
    t0 = time.perf_counter()
    out = fn(*args)
    say("seconds", of=fn.__name__, seconds=round(time.perf_counter() - t0, 3))
    return out


def phase_env(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    from sliceslice_tpu_torch.ops import cuda_lib
    from sliceslice_tpu_torch.utils.profiling import card

    try:
        import triton  # noqa: F401

        triton_ok = True
    except ImportError:
        triton_ok = False
    line = card(0)
    print(line, flush=True)
    say("env", card=line, torch=torch.__version__, cuda=torch.version.cuda,
        device_count=torch.cuda.device_count(), nvcc=cuda_lib.nvcc_path(),
        triton=triton_ok)
    return line


def phase_build():
    from sliceslice_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.load()
    info = cuda_lib.build_info
    summary = [ln.strip() for ln in info.get("ptxas", "").splitlines()
               if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    spills = [ln for ln in summary if "spill" in ln and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    say("build", seconds=round(time.perf_counter() - t0, 3),
        nvcc_seconds=round(info.get("seconds", 0.0), 3),
        library=os.path.relpath(info["library"], REPO), ptxas=summary)
    check(not spills, f"ptxas reports spills: {spills}")


def _kernel_tables(hay: bytes, rng, t: int):
    """Needles of the lengths of one width-t table: present, absent, at
    the last valid position, and the corpus tail plus a zero byte (absent,
    but it matches in the layout's zero halo past the last position)."""
    needles = []
    for k in range(max(1, 4 * t - 11), 4 * t + 1):
        start = int(rng.integers(0, len(hay) - k))
        needles.append(hay[start:start + k])                      # present
        needles.append(bytes(rng.integers(200, 256, k, dtype=np.uint8)))  # absent
        needles.append(hay[-k:])                                   # last position
        needles.append(hay[len(hay) - k + 1:] + b"\0")             # zero tail
    return needles


def _queue_case_needles(hay: bytes, t: int):
    """Width-t needles whose answers the work queue makes hard: the only
    match at the corpus's end (its row's last chunk), absent, a match 5
    bytes before the end, a zero tail (it also matches in the zero halo),
    all zeros (only the halo holds them) and the corpus's first bytes."""
    k = 4 * t
    return [hay[-k:], bytes([1]) * k, hay[-k - 5:-5], hay[len(hay) - k + 1:] + b"\0",
            b"\0" * k, hay[:k]]


def _same(a, b) -> bool:
    return a.dtype == b.dtype and a.equal(b)


def _err(a, b) -> int:
    """Largest absolute difference of two integer tensors of one shape."""
    check(a.shape == b.shape, f"shapes differ: {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def _rank_windows(total: int) -> list:
    """Windows of packed ranks the kernels phase checks: all of them at
    once, thirds, and the first and last 5 windows of 7 and of 1,000
    (windows that cut rows and bitmap words)."""
    out = {(0, total)}
    for step in (7, 1000, max(total // 3, 1)):
        starts = list(range(0, total, step))
        out.update((lo, min(lo + step, total)) for lo in starts[:5] + starts[-5:])
    return sorted(out)


def _positions_checks(flat, v, m, e, base=0, n_real=None):
    """The match-bitmap kernel (words, item counts, chunk; launched twice),
    the rank kernel (with the SENTINEL tail at every cap of CAPS, and
    without) and the compaction kernel, capped at every cap of CAPS and
    packed in the windows of ``_rank_windows``, against their plain
    versions on one table; returns the words, the row totals and the
    bitmap's, the ranks' and the compaction's largest differences."""
    import torch

    from sliceslice_tpu_torch.ops import scan_kernel

    words, counts, chunk = scan_kernel.match_bitmap_counted(flat, v, m, e, base=base, n_real=n_real)
    again = scan_kernel.match_bitmap_counted(flat, v, m, e, base=base, n_real=n_real)
    plain = scan_kernel.match_bitmap_counted_plain(flat, v, m, e, base=base, n_real=n_real)
    where = f"t={v.shape[1]}, base={base}"
    check(all(_same(words, o[0]) and _same(counts, o[1]) and chunk == o[2]
              for o in (again, plain)), f"match-bitmap kernel != plain ({where})")
    bitmap_err = max(_err(words, plain[0]), _err(counts, plain[1]))
    rank_err = compact_err = 0
    for cap in CAPS:
        tail = torch.full((words.shape[0], cap), -3, dtype=torch.int32, device=words.device)
        ref_tail = tail.clone()
        got = scan_kernel.item_ranks(counts, tail) + (tail,)
        ref = scan_kernel.item_ranks_plain(counts, ref_tail) + (ref_tail,)
        rank_err = max([rank_err] + [_err(a, b) for a, b in zip(got, ref)])
        check(all(_same(a, b) for a, b in zip(got, ref)), f"rank kernel != plain ({where}, cap={cap})")
        got = scan_kernel.compact_positions(words, counts, chunk, cap)
        ref = scan_kernel.compact_positions_plain(words, counts, chunk, cap)
        compact_err = max(compact_err, _err(got[0], ref[0]), _err(got[1], ref[1]))
        check(_same(got[0], ref[0]) and _same(got[1], ref[1]),
              f"capped compaction kernel != plain ({where}, cap={cap})")
    totals, first = scan_kernel.item_ranks(counts)
    ref = scan_kernel.item_ranks_plain(counts)
    rank_err = max(rank_err, _err(totals, ref[0]), _err(first, ref[1]))
    check(_same(totals, ref[0]) and _same(first, ref[1]), f"rank kernel != plain ({where}, no tail)")
    cnt = totals.cpu().numpy().astype(np.int64)
    row_base = torch.from_numpy(np.cumsum(cnt) - cnt).to(words.device)
    total = int(cnt.sum())
    whole = torch.full((total,), -2, dtype=torch.int32, device=words.device)
    scan_kernel.compact_window_plain(words, counts, first, chunk, whole, row_base=row_base, window=(0, total))
    for lo, hi in _rank_windows(total):
        got = torch.full((hi - lo,), -1, dtype=torch.int32, device=words.device)
        scan_kernel.compact_window(words, counts, first, chunk, got, row_base=row_base, window=(lo, hi))
        compact_err = max(compact_err, _err(got, whole[lo:hi]))
        check(_same(got, whole[lo:hi]), f"packed compaction kernel != plain ({where}, window {lo}-{hi})")
    return words, totals, bitmap_err, rank_err, compact_err


def _queue_checks(torch, device, hay, flat, needles, t, ends, base=0, n_real=None):
    """Find, count, match-bitmap and compaction kernels against their plain
    versions on one table, each launched twice (the answers must not move),
    the bitmap's row totals against the counts; returns the find and count
    answers as lists."""
    from sliceslice_tpu_torch.needle import build_probe_table
    from sliceslice_tpu_torch.ops import scan_kernel
    from sliceslice_tpu_torch.ops.scan_math import table_bits

    vals, msks, _ = build_probe_table(needles, t_max=t)
    v, m = table_bits(vals, device), table_bits(msks, device)
    e = torch.from_numpy(np.asarray(ends, np.int64).astype(np.int32)).to(device)
    out = []
    for kernel, plain in ((scan_kernel.batched_find, scan_kernel.batched_find_plain),
                          (scan_kernel.batched_count, scan_kernel.batched_count_plain)):
        got = kernel(flat, v, m, e, base=base, n_real=n_real)
        again = kernel(flat, v, m, e, base=base, n_real=n_real)
        ref = plain(flat, v, m, e, base=base, n_real=n_real)
        check(torch.equal(got, again), f"{kernel.__name__}: two launches differ at t={t}")
        check(torch.equal(got, ref), f"{kernel.__name__} != plain on a queue case at t={t}")
        out.append(got.cpu().tolist())
    _, totals, _, _, _ = _positions_checks(flat, v, m, e, base, n_real)
    check(totals.cpu().tolist() == out[1], f"bitmap row totals != counts on a queue case at t={t}")
    return out


def _chunk_table_checks(torch, device, hay, dh):
    """The dense huge-needle tier's operands: one t = 128 table of chunks
    of differing lengths (mask-0 padded slots; present, absent, at the
    last position, a zero tail, dense), with their own ends and with ends
    cut inside the corpus.  The find, count, bitmap, rank and compaction
    kernels (every cap of CAPS, and packed) against their plain versions
    and the host oracles; then the chained bitmap of huge needles, kernel
    against plain.  Returns the bitmap's, the ranks' and the compaction's
    largest differences."""
    from sliceslice_tpu_torch import overlapping_count
    from sliceslice_tpu_torch.config import SENTINEL
    from sliceslice_tpu_torch.models.huge import CHUNK, HugeNeedleSearcher
    from sliceslice_tpu_torch.needle import build_probe_table
    from sliceslice_tpu_torch.ops import chained, torch_backend
    from sliceslice_tpu_torch.ops.scan_math import table_bits
    from sliceslice_tpu_torch.searcher import _host_positions

    t = CHUNK // 4
    chunks = [hay[1000:1512], hay[-512:], hay[5000:5300], hay[-129:], hay[70_000:70_001],
              b"\x7f" * 512, hay[len(hay) - 39:] + b"\0", b"a" * 7, hay[-512:-64]]
    own = np.array([len(hay) - len(c) + 1 for c in chunks])
    vals, msks, _ = build_probe_table(chunks, t_max=t)
    v, m = table_bits(vals, device), table_bits(msks, device)
    f, c = _queue_checks(torch, device, hay, dh.flat, chunks, t, own)
    check(f == [SENTINEL if hay.find(x) < 0 else hay.find(x) for x in chunks]
          and c == [overlapping_count(hay, x) for x in chunks], "t=128 chunk table != host oracles")
    bitmap_err = rank_err = compact_err = 0
    for ends in (own, own - np.arange(len(chunks)) * 1000 - 7):
        e = torch.from_numpy(np.maximum(ends, 0).astype(np.int32)).to(device)
        words, totals, b_err, r_err, c_err = _positions_checks(dh.flat, v, m, e)
        bitmap_err, rank_err, compact_err = max(bitmap_err, b_err), max(rank_err, r_err), max(compact_err, c_err)
        rows = words.cpu().numpy()
        for i, x in enumerate(chunks):
            exp = _host_positions(hay, x)
            check(np.array_equal(torch_backend.decode_match_bitmap(rows[i]), exp[exp < ends[i]]),
                  f"t=128 bitmap row {i} != host positions")
    needles = [hay[3000:5600], hay[-4096:], hay[-2600:-1] + b"\0", b"a" * 2100, hay[:2049]]
    for nd in needles:
        plan = HugeNeedleSearcher(nd, device=device)._chunk_plan()
        got = chained.chained_match_bitmap(dh.flat, *plan, dh.length)
        ref = chained.chained_match_bitmap(dh.flat, *plan, dh.length, plain=True)
        check(all(_same(a, b) for a, b in zip(got, ref)), f"chained bitmap kernel != plain, k={len(nd)}")
        exp = _host_positions(hay, nd)
        check(int(got[0]) == len(exp) and int(got[1]) == (exp[0] if len(exp) else SENTINEL)
              and np.array_equal(torch_backend.decode_match_bitmap(got[2].cpu().numpy()), exp),
              f"chained bitmap != host positions, k={len(nd)}")
        bitmap_err = max(bitmap_err, _err(got[2], ref[2]))
    return bitmap_err, rank_err, compact_err


def _random_words(rng, count: int, max_len: int):
    """Seeded words of lengths 0..max_len over a 3-letter alphabet (so
    short words occur in long ones), plus the empty word."""
    return [bytes(rng.integers(97, 100, int(rng.integers(0, max_len + 1)), dtype=np.uint8))
            for _ in range(count)] + [b""]


def _pair_checks(torch, pairwise, args, exp, what) -> int:
    """The pair kernel in both modes, two launches each, against its plain
    version and the ``bytes.find`` answers ``exp``; returns the largest
    difference from the plain version."""
    plain, cnt_plain = pairwise.pair_block_plain(*args), pairwise.pair_block_plain(*args, count=True)
    check(np.array_equal(plain.cpu().numpy(), exp), f"pair plain version != bytes.find ({what})")
    got, again = pairwise.pair_block(*args), pairwise.pair_block(*args)
    cnt, cnt_again = pairwise.pair_block(*args, count=True), pairwise.pair_block(*args, count=True)
    check(torch.equal(got, again) and int(cnt) == int(cnt_again), f"pair kernel: two launches differ ({what})")
    check(torch.equal(got, plain) and int(cnt) == int(cnt_plain), f"pair kernel != plain ({what})")
    check(int(cnt) == int((exp >= 0).sum()), f"pair kernel count != bytes.find ({what})")
    return max(_err(got, plain), abs(int(cnt) - int(cnt_plain)))


def phase_kernels(torch, device):
    """Find, count, match-bitmap, rank, compaction (capped and packed),
    memchr and pair-block kernels against their plain versions (and the
    host oracles) on the card."""
    from sliceslice_tpu_torch import PairwiseSearcher, overlapping_count, preprocess
    from sliceslice_tpu_torch.config import SENTINEL
    from sliceslice_tpu_torch.needle import build_probe_table, needed_halo_for_t
    from sliceslice_tpu_torch.ops import pairwise, scan_kernel, torch_backend
    from sliceslice_tpu_torch.ops.scan_math import table_bits
    from sliceslice_tpu_torch.scripts import pair_cases
    from sliceslice_tpu_torch.searcher import _host_positions

    rng = np.random.default_rng(1234)
    body = rng.integers(97, 101, (1 << 20) - 128, dtype=np.uint8)
    tail = rng.permutation(np.arange(128, 256, dtype=np.uint8))  # unique bytes
    hay = np.concatenate([body, tail]).tobytes()
    dh = preprocess(hay, kh=needed_halo_for_t(512), device=device)
    widths = list(range(1, 9)) + [16, 32, 512]
    max_err = count_err = bitmap_err = rank_err = compact_err = 0
    rows = queue_cases = 0
    for t in widths:
        needles = _kernel_tables(hay, rng, t)
        vals, msks, lens = build_probe_table(needles, t_max=t)
        n_pad = len(needles) + 8  # padded rows: mask 0, end 0
        vals = np.pad(vals, ((0, 8), (0, 0)))
        msks = np.pad(msks, ((0, 8), (0, 0)))
        ends = np.pad(np.maximum(len(hay) - lens + 1, 0).astype(np.int64), (0, 8))
        counts = np.array([overlapping_count(hay, nd) for nd in needles] + [0] * 8)
        for base, n_real in ((0, n_pad), (4096, n_pad - 11)):
            e = torch.from_numpy((ends + np.where(ends > 0, base, 0)).astype(np.int32)).to(device)
            v, m = table_bits(vals, device), table_bits(msks, device)
            got = scan_kernel.batched_find(dh.flat, v, m, e, base=base, n_real=n_real)
            plain = scan_kernel.batched_find_plain(dh.flat, v, m, e, base=base, n_real=n_real)
            got, plain = got.cpu().numpy(), plain.cpu().numpy()
            max_err = max(max_err, int(np.abs(got.astype(np.int64) - plain).max()))
            check(np.array_equal(got, plain), f"find kernel != plain at t={t} base={base}")
            exp = np.full(n_pad, SENTINEL, np.int64)
            for i, nd in enumerate(needles[:n_real]):
                f = hay.find(nd)
                exp[i] = SENTINEL if f < 0 else f + base
            check(np.array_equal(got, exp), f"find kernel != bytes.find at t={t} base={base}")
            got = scan_kernel.batched_count(dh.flat, v, m, e, base=base, n_real=n_real).cpu().numpy()
            plain = scan_kernel.batched_count_plain(dh.flat, v, m, e, base=base, n_real=n_real)
            plain = plain.cpu().numpy()
            count_err = max(count_err, int(np.abs(got.astype(np.int64) - plain).max()))
            check(np.array_equal(got, plain), f"count kernel != plain at t={t} base={base}")
            exp = np.where(np.arange(n_pad) < n_real, counts, 0)
            check(np.array_equal(got, exp), f"count kernel != overlapping_count at t={t} base={base}")
            got, totals, b_err, r_err, c_err = _positions_checks(dh.flat, v, m, e, base, n_real)
            bitmap_err, rank_err, compact_err = max(bitmap_err, b_err), max(rank_err, r_err), max(compact_err, c_err)
            check(np.array_equal(totals.cpu().numpy(), exp), f"bitmap row totals != counts at t={t} base={base}")
            if base == 0:
                words = got.cpu().numpy()
                for i, nd in enumerate(needles):
                    check(np.array_equal(torch_backend.decode_match_bitmap(words[i]),
                                         _host_positions(hay, nd)),
                          f"match-bitmap kernel != host positions at t={t}, row {i}")
            rows += n_pad
        # The work queue's hard cases (the ends of each row and of the
        # buffer, one-row launches), exact against the host oracles too.
        qn = _queue_case_needles(hay, t)
        right = np.array([len(hay) - len(nd) + 1 for nd in qn])
        f, c = _queue_checks(torch, device, hay, dh.flat, qn, t, right)
        check(f == [SENTINEL if hay.find(nd) < 0 else hay.find(nd) for nd in qn],
              f"find kernel != bytes.find on the queue cases at t={t}")
        check(c == [overlapping_count(hay, nd) for nd in qn],
              f"count kernel != overlapping_count on the queue cases at t={t}")
        n_pos = scan_kernel.position_limit(dh.flat.numel(), t)
        for ends in (right - 7, right + 5, np.full(len(qn), n_pos - 3), np.full(len(qn), 1 << 30)):
            _queue_checks(torch, device, hay, dh.flat, qn, t, ends)
        for base, n_real in ((4096, len(qn) - 2), (1 << 20, 1)):
            _queue_checks(torch, device, hay, dh.flat, qn, t, right + base, base, n_real)
        for nd, end in zip(qn, right):
            f, c = _queue_checks(torch, device, hay, dh.flat, [nd], t, [end])
            check(f == [SENTINEL if hay.find(nd) < 0 else hay.find(nd)]
                  and c == [overlapping_count(hay, nd)], f"one-row launch differs at t={t}")
        queue_cases += 7 + len(qn)  # tables, each launched twice per kernel
    b_err, r_err, c_err = _chunk_table_checks(torch, device, hay, dh)
    bitmap_err, rank_err, compact_err = max(bitmap_err, b_err), max(rank_err, r_err), max(compact_err, c_err)
    queue_cases += 1
    find_err = max_err
    max_err = 0
    cases = 0
    for byte in (97, 100, int(tail[0]), int(tail[-1]), 0, 255):
        for end, base in ((len(hay), 0), (len(hay) // 2, 0), (len(hay) + 4096, 4096)):
            got = int(scan_kernel.memchr_find(dh.flat, byte, end, base))
            plain = int(scan_kernel.memchr_find_plain(dh.flat, byte, end, base))
            max_err = max(max_err, abs(got - plain))
            f = hay.find(bytes([byte]), 0, end - base)
            check(got == plain == (SENTINEL if f < 0 else f + base),
                  f"memchr kernel != plain/bytes.find for byte {byte} end {end} base {base}")
            cases += 1
    memchr_err = max_err

    # Pair block: word sets of lengths 0-64 with the empty word, swept
    # against themselves in one block and against other words in blocks of
    # 64; both modes, against the plain version and bytes.find.
    pair_err = pairs = 0
    ws = sorted(_random_words(rng, 700, 64), key=len)
    for hs, block in ((None, pairwise.BLOCK), (_random_words(rng, 500, 72), 64)):
        ps = PairwiseSearcher(ws, block=block, device=device)
        pk, lh, _, _ = ps._pack_hay(hs)
        args = (ps._values, ps._masks, ps._ln, pk, lh, ps._plan(hs), block)
        hs = ws if hs is None else hs
        exp = np.array([[h.find(nd) for h in hs] for nd in ws], dtype=np.int32)
        pair_err = max(pair_err, _pair_checks(torch, pairwise, args, exp, f"block {block}"))
        pairs += exp.size
    # The kernel's hard cases.
    hard = pair_cases.cases()
    for case in hard:
        args, exp = pair_cases.operands(case, device)
        pair_err = max(pair_err, _pair_checks(torch, pairwise, args, exp, case.name))
        pairs += exp.size
    say("kernels", find_rows=rows, find_widths=widths, find_max_abs_err=find_err,
        queue_case_tables=queue_cases, chunk_table_t=128,
        count_rows=rows, count_max_abs_err=count_err, bitmap_rows=rows,
        bitmap_max_abs_err=bitmap_err, rank_max_abs_err=rank_err, compaction_caps=list(CAPS),
        compaction_modes=["capped", "packed"], compaction_max_abs_err=compact_err,
        memchr_cases=cases, memchr_max_abs_err=memchr_err,
        pair_pairs=pairs, pair_hard_cases=[c.name for c in hard],
        pair_max_abs_err=pair_err, equal=True)
    return {"batched_find": find_err, "memchr_find": memchr_err,
            "batched_count": count_err, "pair_block": pair_err, "match_bitmap": bitmap_err,
            "item_ranks": rank_err, "compact_window": compact_err}


def phase_i386(torch, device, hay, words):
    from sliceslice_tpu_torch import BatchedSearcher, preprocess

    dh = preprocess(hay, kh=24, device=device)
    bs = BatchedSearcher(words, device=device)
    exp = np.array([hay.find(w) for w in words])
    got = bs.find_all(dh)
    check(np.array_equal(got, exp), f"i386 sweep: {int((got != exp).sum())} words differ")
    bs.optimize_for(dh)
    got2 = bs.find_all(dh)
    check(np.array_equal(got2, exp), "i386 sweep after optimize_for differs")
    widths = {g.t: g.n for g in bs.groups}
    say("i386", words=len(words), corpus_bytes=len(hay), groups=widths,
        parity=True, parity_after_optimize_for=True)
    return dh, bs, exp


def phase_dynamic(torch, device, hay):
    from sliceslice_tpu_torch import DynamicSearcher, preprocess

    rng = np.random.default_rng(7)
    small = hay[100_000:106_000]          # bytes, 4096 < len <= 8192: flat rung
    tiny = preprocess(hay[:3000], device=device)   # DeviceHaystack, flat rung
    big = preprocess(hay, kh=64, device=device)    # kernel layout
    m0 = counter("launches.memchr_find")
    lengths = [1, 2, 3, 5, 8, 12, 16, 17, 24, 32, 33, 40, 100, 1000]
    checked = 0
    for k in lengths:
        for h_bytes, h in ((small, small), (hay[:3000], tiny), (hay, big), (hay, hay)):
            start = int(rng.integers(0, len(h_bytes) - k))
            for nd in (h_bytes[start:start + k], h_bytes[-k:], b"\xfe" * k):
                got = DynamicSearcher(nd, device=device).find(h)
                f = h_bytes.find(nd)
                check(got == (None if f < 0 else f), f"DynamicSearcher k={k} differs")
                checked += 1
    memchr_runs = counter("launches.memchr_find") - m0
    check(memchr_runs > 0, "the 1-byte arm never launched the memchr kernel")
    say("dynamic", lengths=lengths, checks=checked, memchr_launches=memchr_runs,
        parity=True)


def phase_big(torch, device):
    from sliceslice_tpu_torch import BatchedSearcher, DynamicSearcher, preprocess

    rng = np.random.default_rng(2024)
    arr = rng.integers(0, 250, BIG_BYTES, dtype=np.uint8)
    planted = []
    offsets = np.sort(rng.choice(BIG_BYTES - 4096, 32, replace=False))
    for off in offsets:
        k = int(rng.integers(1, 65))
        nd = rng.integers(0, 250, k, dtype=np.uint8)
        arr[off:off + k] = nd
        planted.append(nd.tobytes())
    # A periodic run of bytes the random body never holds, for the count
    # phase's overlapping matches, and a needle only the last 100 bytes
    # hold (its row's last chunk in the find and count kernels' queue).
    arr[BIG_BYTES - 3000:BIG_BYTES - 1000] = np.tile(np.array([250, 251], np.uint8), 1000)
    arr[BIG_BYTES - 100:BIG_BYTES - 100 + len(LAST_CHUNK_NEEDLE)] = np.frombuffer(LAST_CHUNK_NEEDLE, np.uint8)
    absent = [bytes([255]) + rng.integers(0, 250, k - 1, dtype=np.uint8).tobytes()
              for k in (1, 2, 3, 4, 7, 12, 24, 40)]
    hay = arr.tobytes()
    needles = planted + absent
    t0 = time.perf_counter()
    dh = preprocess(arr, kh=64, device=device)
    dh.flat[-1].item()  # wait for the upload
    upload_s = time.perf_counter() - t0
    exp = np.array([hay.find(nd) for nd in needles])
    got = BatchedSearcher(needles, device=device).find_all(dh)
    check(np.array_equal(got, exp), f"256 MiB corpus: {int((got != exp).sum())} needles differ")
    last = planted[-1]
    check(DynamicSearcher(last, device=device).find(dh) == hay.find(last),
          "256 MiB corpus: DynamicSearcher differs")
    check(DynamicSearcher(b"\xff", device=device).find(dh) is None,
          "256 MiB corpus: absent byte found")
    say("big", corpus_bytes=BIG_BYTES, planted=len(planted), absent=len(absent),
        max_offset=int(exp.max()), upload_s=round(upload_s, 3), parity=True)
    return dh, hay, needles


def phase_queue_big(torch, device, big):
    """One-row launches of the find and count kernels over the 256 MiB
    corpus, against their plain versions and the host oracles: a needle
    only in its row's last chunk, an absent one (every chunk scanned) and a
    planted one; two launches each."""
    from sliceslice_tpu_torch import overlapping_count
    from sliceslice_tpu_torch.config import SENTINEL
    from sliceslice_tpu_torch.ops import scan_kernel

    big_dh, big_hay, big_needles = big
    absent = bytes([255]) + big_hay[1000:1010]
    checked = []
    for nd in (LAST_CHUNK_NEEDLE, absent, big_needles[len(big_needles) // 2]):
        t = max(1, -(-len(nd) // 4))
        f, c = _queue_checks(torch, device, big_hay, big_dh.flat, [nd], t, [len(big_hay) - len(nd) + 1])
        exp = big_hay.find(nd)
        check(f == [SENTINEL if exp < 0 else exp], f"256 MiB one-row find differs for {nd!r}")
        check(c == [overlapping_count(big_hay, nd)], f"256 MiB one-row count differs for {nd!r}")
        checked.append({"needle_len": len(nd), "first": exp, "count": c[0]})
    lim = len(big_hay) - len(LAST_CHUNK_NEEDLE) + 1
    plans = [scan_kernel.plan_queue(big_dh.flat.numel(), 3, 1, 1, c)
             for c in (scan_kernel.FIND_CHUNK, scan_kernel.COUNT_CHUNK)]
    check(all(big_hay.find(LAST_CHUNK_NEEDLE) >= (lim - 1) // p.chunk * p.chunk for p in plans),
          "the last-chunk needle does not lie in its row's last chunk")
    say("queue_big", corpus_bytes=len(big_hay), rows=checked, chunks_per_row=[p.n_chunks for p in plans],
        equal_to_plain=True, equal_to_host=True)


def phase_group_wide(torch, device):
    """The count and bitmap group walk of tables of 5 to 8 slots at the
    shapes it runs in: on a seeded 64 MiB ACGT text, per width, one
    launch of each kernel planned at 8 rows an item with no patched
    chunk, its rows counted as tiled and two-slot rows, its answers equal
    to the plain versions', the bitmap's totals to the counts, and
    sampled rows to ``overlapping_count``.  Guides are cut from the text;
    the first 8 of each width are planted whole twice and, 3 times, with
    their last byte changed (windows that pass slots 0 and 1 and fail a
    later slot); the last row is the text's last bytes."""
    from sliceslice_tpu_torch import overlapping_count, preprocess
    from sliceslice_tpu_torch.needle import build_probe_table, needed_halo_for_t
    from sliceslice_tpu_torch.ops import scan_kernel
    from sliceslice_tpu_torch.ops.scan_math import table_bits

    rng = np.random.default_rng(2024)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    text = acgt[rng.integers(0, 4, GROUP_WIDE_BYTES)]
    lengths = {t: ([20] * n if t == 5 else [4 * t - 3 + i % 4 for i in range(n)])
               for t, n in GROUP_WIDE_ROWS.items()}
    sources = {t: rng.choice(GROUP_WIDE_BYTES - 64, len(ks), replace=False) for t, ks in lengths.items()}
    guides = {t: [text[a : a + k].tobytes() for a, k in zip(sources[t], lengths[t])] for t in lengths}
    for t in lengths:
        for nd in guides[t][:8]:
            changed = nd[:-1] + bytes([acgt[(b"ACGT".index(nd[-1:]) + 1) % 4]])
            for copy in [nd] * 2 + [changed] * 3:
                at = int(rng.integers(0, GROUP_WIDE_BYTES - len(copy)))
                text[at : at + len(copy)] = np.frombuffer(copy, np.uint8)
    hay = text.tobytes()
    for t in lengths:
        guides[t][-1] = hay[-lengths[t][-1]:]
    dh = preprocess(hay, kh=needed_halo_for_t(max(lengths)), device=device)
    rows, sampled, planned = {}, 0, {}
    for t, needles in guides.items():
        vals, msks, lens = build_probe_table(needles, t_max=t)
        v, m = table_bits(vals, device), table_bits(msks, device)
        e = torch.from_numpy(np.maximum(len(hay) - lens + 1, 0).astype(np.int32)).to(device)
        n = len(needles)
        planned[t] = [scan_kernel._queue_plan(mode, dh.flat, t, n).group
                      for mode in (scan_kernel.COUNT, scan_kernel.BITMAP)]
        check(planned[t] == [scan_kernel.GROUP_ROWS] * 2, f"t={t}: {n} rows over 64 MiB not planned "
              f"at {scan_kernel.GROUP_ROWS} rows an item: {planned[t]}")
        names = [f"{kind}.{w}" for kind in ("tiled_rows", "single_rows", "two_slot_rows")
                 for w in ("batched_count", "match_bitmap_counted")]
        before = [counter(name) for name in names]
        got = scan_kernel.batched_count(dh.flat, v, m, e)
        words, counts, chunk = scan_kernel.match_bitmap_counted(dh.flat, v, m, e)
        torch.cuda.synchronize()
        made = [counter(name) - b for name, b in zip(names, before)]
        check(made == [n, n, 0, 0, n, n], f"t={t}: row counters moved by {dict(zip(names, made))}")
        check(torch.equal(got, scan_kernel.batched_count_plain(dh.flat, v, m, e)),
              f"grouped count kernel != plain at t={t}")
        plain = scan_kernel.match_bitmap_counted_plain(dh.flat, v, m, e)
        check(torch.equal(words, plain[0]) and torch.equal(counts, plain[1]) and chunk == plain[2],
              f"grouped match-bitmap kernel != plain at t={t}")
        del words, plain
        check(torch.equal(counts.sum(dim=0, dtype=torch.int32), got), f"bitmap totals != counts at t={t}")
        got = got.cpu().tolist()
        picks = sorted({*range(8), n - 1, *rng.choice(n - 1, GROUP_WIDE_ORACLE_ROWS - 9, replace=False)})
        for i in picks:
            check(got[i] == overlapping_count(hay, needles[i]),
                  f"grouped count != overlapping_count at t={t}, row {i}")
        sampled += len(picks)
        rows[t] = {"rows": n, "lengths": sorted(set(lengths[t])), "total": int(sum(got)),
                   "max": int(max(got)), "planted_counts": got[:8]}
    say("group_wide", corpus_bytes=len(hay), rows_per_item=planned, widths=rows,
        oracle_rows=sampled, equal_to_plain=True, equal_to_host=True)


def _flip(nd: bytes) -> bytes:
    """``nd`` with its middle byte changed: the prefix filter passes where
    ``nd`` occurs, the verify must reject."""
    mid = len(nd) // 2
    return nd[:mid] + bytes([nd[mid] ^ 0x40]) + nd[mid + 1:]


def _ascii_slice(hay: bytes, start: int, k: int) -> bytes:
    """The first ASCII slice of ``k`` bytes with no NUL at or after
    ``start``: a needle the command line carries as it is."""
    a = np.frombuffer(hay, np.uint8)
    bad = np.concatenate([[0], np.cumsum((a >= 128) | (a == 0))])
    clean = np.flatnonzero(bad[k:] == bad[:-k])  # windows [i, i + k) without such bytes
    i = int(clean[np.searchsorted(clean, start)])
    return hay[i:i + k]


#: Launches (count, bitmap, ranks, compaction) of one huge-needle call per
#: tier: the prefix count, then the candidates' bitmap, ranks and capped
#: compaction (host) or the chunks' bitmap (dense).
TIER_LAUNCHES = {"host": (1, 1, 1, 1), "dense": (1, 1, 0, 0)}


def _huge_calls(torch, device, cases, what):
    """DynamicSearcher find / count_in / positions of each ``(needle,
    layout, (first, count, positions), tier)`` case, exact, each call on
    its tier with that tier's launches."""
    from sliceslice_tpu_torch import DynamicSearcher

    def counts():
        return (counter("launches.batched_count"), counter("launches.match_bitmap_counted"),
                counter("launches.item_ranks"), counter("launches.compact_window"))

    for nd, dh, (first, count, positions), tier in cases:
        ds = DynamicSearcher(nd, device=device)
        got_tier = ds.inner._route(dh, dh.host_bytes)[0]
        check(got_tier == tier, f"{what} k={len(nd)}: tier {got_tier}, not {tier}")
        for op, want in (("find", first), ("count_in", count), ("positions", positions)):
            before = counts()
            got = getattr(ds, op)(dh)
            torch.cuda.synchronize()
            made = tuple(a - b for a, b in zip(counts(), before))
            same = np.array_equal(got, want) if op == "positions" else got == want
            check(same, f"{what} k={len(nd)} {op} differs")
            check(made == TIER_LAUNCHES[tier], f"{what} k={len(nd)} {op}: launches {made}, "
                  f"not {TIER_LAUNCHES[tier]} of the {tier} tier")


def phase_huge(torch, device, card, hay, words, i386_dh, i386_answers, big):
    """Needles longer than 2,048 bytes on the card, each case exact and on
    its designed tier with its launches: i386 needles of 2,049 to 65,536
    bytes and their absent variants (sparse tier; alone and in one
    BatchedSearcher with all 4,585 words), the 256 MiB corpus's needles of
    2,049 to 1,048,576 bytes (sparse), a period-1 corpus and a corpus of
    20,000 records sharing one prefix (dense), its first 16,000 records
    (sparse, 16,000 candidates).  Then ms per call of each tier and
    operation, the host verify's share, and the chunk bitmap at t = 128
    against its bound."""
    from sliceslice_tpu_torch import BatchedSearcher, DynamicSearcher, preprocess
    from sliceslice_tpu_torch.models import huge
    from sliceslice_tpu_torch.needle import needed_halo_for_t
    from sliceslice_tpu_torch.ops import chained, scan_kernel
    from sliceslice_tpu_torch.ops.scan_math import position_limit
    from sliceslice_tpu_torch.searcher import _host_positions, overlapping_count
    from sliceslice_tpu_torch.utils.profiling import bound_ms, measure

    def answers(h, nd):
        f = h.find(nd)
        return (None if f < 0 else f), overlapping_count(h, nd), _host_positions(h, nd)

    # i386, sparse tier.
    i386 = []
    for i, k in enumerate((2049, 4096, 16384, 65536)):
        nd = hay[100_000 + 150_000 * i:100_000 + 150_000 * i + k]
        i386 += [nd, _flip(nd)]
    _huge_calls(torch, device, [(nd, i386_dh, answers(hay, nd), "host") for nd in i386], "i386")
    i386_firsts, i386_counts, i386_positions = i386_answers
    bs = BatchedSearcher(list(words) + i386, device=device)
    got = bs.find_all(i386_dh)
    check(np.array_equal(got, np.concatenate([i386_firsts, [hay.find(nd) for nd in i386]])),
          "i386 words + huge needles: find_all differs")
    got = bs.count_all(i386_dh)
    check(np.array_equal(got, np.concatenate([i386_counts, [overlapping_count(hay, nd) for nd in i386]])),
          "i386 words + huge needles: count_all differs")
    got = bs.positions_all(i386_dh)
    exp = list(i386_positions) + [_host_positions(hay, nd) for nd in i386]
    check(all(np.array_equal(a, b) for a, b in zip(got, exp)) and len(got) == len(exp),
          "i386 words + huge needles: positions_all differs")

    # The 256 MiB corpus (random bytes), sparse tier: each slice occurs
    # once, its absent variant never; the prefixes are checked unique.
    big_dh, big_hay, _ = big
    cases = []
    n = len(big_hay)
    for off, k in ((n // 20, 2049), (n * 9 // 16, 65_536), (n * 3 // 4, min(1 << 20, n // 8))):
        nd = big_hay[off:off + k]
        check(big_hay.find(nd[:64]) == off and big_hay.find(nd[:64], off + 1) < 0,
              "256 MiB corpus: a huge needle's prefix is not unique")
        cases += [(nd, big_dh, (off, 1, np.array([off])), "host"),
                  (_flip(nd), big_dh, (None, 0, np.zeros(0, np.int64)), "host")]
    _huge_calls(torch, device, cases, "256 MiB corpus")

    # Dense, period 1: 16 runs of 1,048,575 'a' and one 'b'.
    run = 1 << 20
    arr = np.full(16 * run, ord("a"), np.uint8)
    arr[run - 1::run] = ord("b")
    p1 = preprocess(arr, device=device)
    k = 8192
    per_run = run - 1 - k + 1
    p1_pos = (np.arange(16, dtype=np.int64)[:, None] * run + np.arange(per_run)).reshape(-1)
    check(len(p1_pos) == 16_646_144, "period-1 expectation")
    ones = b"a" * k
    absent1 = b"a" * (k // 2) + b"c" + b"a" * (k // 2 - 1)
    check(huge.HugeNeedleSearcher(ones, device=device)._chunk_plan()[2] == (0,) * 16,
          "the period-1 needle does not share one chunk row")
    _huge_calls(torch, device, [(ones, p1, (0, len(p1_pos), p1_pos), "dense"),
                                (absent1, p1, (None, 0, np.zeros(0, np.int64)), "dense")], "period 1")

    # Dense, aperiodic: 20,000 records of one 64-byte prefix and 448
    # seeded bytes; a needle of 8 records from record 12,345.
    rng = np.random.default_rng(77)
    rec = rng.integers(0, 256, (20_000, 512), dtype=np.uint8)
    rec[:, :64] = rng.integers(0, 256, 64, dtype=np.uint8)
    ap_hay = rec.tobytes()
    ap = preprocess(ap_hay, device=device)
    r0 = 12_345 * 512
    nd_ap = ap_hay[r0:r0 + 4096]
    check(len(huge.HugeNeedleSearcher(nd_ap, device=device)._chunk_plan()[0]) == 8, "U != 8")
    check(ap_hay.find(nd_ap) == r0 and ap_hay.find(nd_ap, r0 + 1) < 0 and _flip(nd_ap) not in ap_hay,
          "aperiodic corpus: the needle is not unique")
    _huge_calls(torch, device, [(nd_ap, ap, (r0, 1, np.array([r0])), "dense"),
                                (_flip(nd_ap), ap, (None, 0, np.zeros(0, np.int64)), "dense")], "aperiodic")
    # Its first 16,000 records: 16,000 candidates, the sparse tier's worst.
    sp_hay = ap_hay[:16_000 * 512]
    sp = preprocess(sp_hay, device=device)
    nd_sp = sp_hay[r0:r0 + 4096]
    _huge_calls(torch, device, [(nd_sp, sp, (r0, 1, np.array([r0])), "host"),
                                (_flip(nd_sp), sp, (None, 0, np.zeros(0, np.int64)), "host")],
                "16,000 candidates")

    # Times: CUDA events around each call (its readbacks synchronise),
    # median of 3 after one warm call.
    tiers = {"sparse, i386, k=4,096": (i386[2], i386_dh), "sparse, 16,000 candidates": (nd_sp, sp),
             "dense, period 1, 16 MiB": (ones, p1), "dense, aperiodic, U=8, 10 MB": (nd_ap, ap)}
    ms = {}
    for name, (nd, dh) in tiers.items():
        ds = DynamicSearcher(nd, device=device)
        ms[name] = {op: measure(lambda op=op: getattr(ds, op)(dh), f"{name} {op}", warmup=1, samples=3,
                                device=device).estimate * 1e3
                    for op in ("find", "count_in", "positions")}
    # The host verify's share of a sparse call: the verify alone and the
    # whole count_in, both on the host clock, in turns, medians of 5.
    verify = {}
    for name in ("sparse, i386, k=4,096", "sparse, 16,000 candidates"):
        nd, dh = tiers[name]
        hs = DynamicSearcher(nd, device=device).inner
        cands = hs._route(dh, dh.host_bytes)[1]
        v_s, c_s = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            sum(1 for _ in hs._verified(dh.host_bytes, cands))
            t1 = time.perf_counter()
            hs.count_in(dh)
            torch.cuda.synchronize()
            v_s.append(t1 - t0)
            c_s.append(time.perf_counter() - t1)
        v_ms, c_ms = sorted(v_s)[2] * 1e3, sorted(c_s)[2] * 1e3
        verify[name] = {"candidates": len(cands), "verify_ms": v_ms, "count_in_ms_host_clock": c_ms,
                        "share": v_ms / c_ms}
    # The chunk bitmap at t = 128: one launch over the aperiodic corpus's
    # 8 unique chunks, kernel and plain version, and its bound.
    hs = huge.HugeNeedleSearcher(nd_ap, device=device)
    tables, lens, _, _ = hs._chunk_plan()
    needed = needed_halo_for_t(huge.CHUNK // 4)
    dh128 = ap.ensure_halo(needed)
    values, masks = chained._table(tables)
    ends = np.maximum(ap.length - np.asarray(lens) + 1, 0).astype(np.int32)
    _, v, m, e = scan_kernel._operands(dh128.flat, values, masks, ends, 0)
    kern = measure(lambda: scan_kernel.match_bitmap_counted(dh128.flat, v, m, e), "bitmap t=128",
                   warmup=1, samples=5, device=device).estimate * 1e3
    plain = measure(lambda: scan_kernel.match_bitmap_counted_plain(dh128.flat, v, m, e), "bitmap t=128 plain",
                    warmup=1, samples=3, device=device).estimate * 1e3
    numel = dh128.flat.numel()
    lim = np.minimum(ends.astype(np.int64), position_limit(numel, v.shape[1]))
    words_out = scan_kernel.bitmap_words(numel, v.shape[1])
    n_chunks = -(-position_limit(numel, v.shape[1]) // scan_kernel.BITMAP_CHUNK)
    bound = bound_ms(int(lim.sum()), numel + 4 * len(lens) * (2 * v.shape[1] + 1 + words_out + n_chunks))
    say("huge", card=card, ms_per_call=ms, host_verify=verify,
        bitmap_t128={"rows": len(lens), "corpus_bytes": ap.length, "kernel_ms": kern, "plain_ms": plain,
                     "bound_ms": bound[0], "bound_by": bound[1], "halo": needed},
        i386_needles=[len(nd) for nd in i386], batched_rows=len(bs), big_needles=[len(c[0]) for c in cases],
        period1_matches=len(p1_pos), parity=True)
    return i386


#: The stream phase's windows: 64 KiB over i386 (14 windows), 1 MiB over
#: the 256 MiB corpus (256 windows), 128 MiB over the 4.5 GiB chunk
#: stream, 128 KiB and 32 KiB with huge needles (the latter grows to the
#: overlap).
STREAM_I386_WINDOW = 64 * 1024
STREAM_SMALL_WINDOW = 1 << 20
STREAM_BIG_WINDOW = 128 << 20
STREAM_HUGE_WINDOWS = (128 * 1024, 32 * 1024)
#: The 4.5 GiB chunk stream, made of one seeded lowercase block per chunk
#: with the uppercase plants of the port's scripts/bigscan_check.py
#: (the JAX script's) written in.
STREAM_BIG_BYTES = int(4.5 * 2**30)
STREAM_BLOCK = 64 << 20
#: Timed samples per mode of the 256 MiB file at the default windows and of
#: the single-layout calls beside them.
STREAM_SAMPLES = 3


def _stream_held(sc, src, exp_first, exp_counts, exp_pos, what, start=0):
    """find (early_stop False and True), count and positions of one
    scanner over a file path or a chunk-iterator factory, each exact.
    Returns the windows of one stream."""
    if isinstance(src, str):
        calls = {"find": lambda: sc.find_in_file(src, early_stop=False),
                 "find early_stop": lambda: sc.find_in_file(src, early_stop=True),
                 "count": lambda: sc.count_in_file(src), "positions": lambda: sc.positions_in_file(src)}
    else:
        calls = {"find": lambda: sc.find_in_chunks(src(), early_stop=False, start_offset=start),
                 "find early_stop": lambda: sc.find_in_chunks(src(), early_stop=True, start_offset=start),
                 "count": lambda: sc.count_in_chunks(src()),
                 "positions": lambda: sc.positions_in_chunks(src(), start_offset=start)}
    for name, call in calls.items():
        got = call()
        if name == "positions":
            bad = sum(not np.array_equal(g, e) for g, e in zip(got, exp_pos))
            check(len(got) == len(exp_pos) and bad == 0, f"stream {what} {name}: {bad} needles differ")
        else:
            exp = exp_counts if name == "count" else exp_first
            check(np.array_equal(got, exp), f"stream {what} {name}: {int((got != np.asarray(exp)).sum())} "
                  "needles differ")
    return sc.stats["windows"]


def _straddles(positions, needles, window: int) -> int:
    """Matches that start in one window and end in the next."""
    return int(sum(((p // window) != ((p + len(nd) - 1) // window)).sum() for p, nd in zip(positions, needles)))


def phase_stream(torch, device, card, hay, words, i386_answers, big, big_answers, i386_huge):
    """Streams of any length through ``StreamingScanner``, each case exact:
    i386 at 64 KiB windows (all 4,585 words; prefetch 2 then 0; file and
    10,007-byte chunks), the 256 MiB corpus written to a file (its 41
    needles at 32 MiB and at 1 MiB windows, five early-stopped finds on
    one scanner and one stop mid-stream), a 4.5 GiB chunk stream with
    bigscan_check's plants at 128 MiB windows (int64 offsets past 2^31 and
    2^32; and a stream that starts at 2^32 - window + 64), the words and
    the huge phase's i386 needles at 128 KiB and 32 KiB windows.  Then GB/s
    per mode over the file, with the stats split, and each kernel's
    launches per window, held above 0 in its mode."""
    import tempfile

    from sliceslice_tpu_torch import StreamingScanner, overlapping_count
    from sliceslice_tpu_torch.scripts.bigscan_check import expected, make_plants
    from sliceslice_tpu_torch.scripts.multihost_check import plant_chunks
    from sliceslice_tpu_torch.searcher import _host_positions
    from sliceslice_tpu_torch.utils.profiling import measure

    i386_firsts, i386_counts, i386_positions = i386_answers
    path = os.path.join(REPO, "data/i386.txt")
    out = {}

    # 1. i386, all words, 64 KiB windows: prefetch 2, then 0.
    def chunks():
        return (hay[i:i + 10_007] for i in range(0, len(hay), 10_007))

    for prefetch in (2, 0):
        sc = StreamingScanner(words, window_bytes=STREAM_I386_WINDOW, prefetch=prefetch, device=device)
        windows = _stream_held(sc, path, i386_firsts, i386_counts, i386_positions, f"i386 prefetch={prefetch}")
        _stream_held(sc, chunks, i386_firsts, i386_counts, i386_positions, f"i386 chunks prefetch={prefetch}")
    check(windows == 14, f"i386 at 64 KiB windows: {windows} windows, not 14")
    out["i386"] = {"windows": windows, "straddling_matches": _straddles(i386_positions, words, sc.window)}
    check(out["i386"]["straddling_matches"] > 0, "no i386 match straddles a window boundary")

    # 2. The 256 MiB corpus as a file: 41 needles at 32 MiB and 1 MiB.
    big_dh, big_hay, _ = big
    needles, big_firsts, big_counts, big_positions = big_answers
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        big_path = os.path.join(tmp, "big.bin")
        with open(big_path, "wb") as f:
            f.write(big_hay)
        sc = StreamingScanner(needles, device=device).warmup()
        made = sc.buffer_allocations
        windows = _stream_held(sc, big_path, big_firsts, big_counts, big_positions, "256 MiB, 32 MiB windows")
        # Times on a warm page cache, and the launches of one window.
        names = {"find": "batched_find", "count": "batched_count", "bitmap": "match_bitmap_counted",
                 "ranks": "item_ranks", "compaction": "compact_window"}

        def file_times(sc, label, samples):
            """Host-clock seconds (median) and GB/s of each mode's stream
            over the file, its stats, and each kernel's launches per
            window."""
            per_window = {}
            for mode, call in (("find", lambda: sc.find_in_file(big_path, early_stop=False)),
                               ("count", lambda: sc.count_in_file(big_path)),
                               ("positions", lambda: sc.positions_in_file(big_path))):
                before = {k: counter("launches." + w) for k, w in names.items()}
                m = measure(call, f"stream {mode}", warmup=0, samples=samples)
                runs = samples * sc.stats["windows"]
                per_window[mode] = {k: (counter("launches." + w) - before[k]) / runs for k, w in names.items()}
                times[f"file 256 MiB, {label}, {mode}"] = {
                    "s": m.estimate, "low_s": m.low, "GBps": len(big_hay) / m.estimate / 1e9,
                    "stats": sc.stats_summary()}
            return per_window

        per_window = file_times(sc, "32 MiB windows", STREAM_SAMPLES)
        check(sc.buffer_allocations == made, "a stream after warmup allocated a window buffer")
        for mode, kernels in (("find", ("find",)), ("count", ("count",)), ("positions", ("bitmap", "ranks", "compaction"))):
            for k in kernels:
                check(per_window[mode][k] > 0, f"a {mode} stream window launched no {k} kernel")
        sc = StreamingScanner(needles, window_bytes=STREAM_SMALL_WINDOW, device=device)
        small_windows = _stream_held(sc, big_path, big_firsts, big_counts, big_positions, "256 MiB, 1 MiB windows")
        file_times(sc, "1 MiB windows", 1)
        for i in range(5):
            got = sc.find_in_file(big_path, early_stop=True)
            check(np.array_equal(got, big_firsts), f"256 MiB at 1 MiB windows: early-stopped find {i} differs")
        early = [nd for nd, f in zip(needles, big_firsts) if 0 <= f < len(big_hay) // 2]
        ec = StreamingScanner(early, window_bytes=STREAM_SMALL_WINDOW, check_every=1, device=device)
        got = ec.find_in_file(big_path, early_stop=True)
        check(np.array_equal(got, [big_hay.find(nd) for nd in early]) and ec.stats["windows"] < small_windows,
              "256 MiB at 1 MiB windows: the stop mid-stream differs")
        stopped_at = ec.stats["windows"]
        check(np.array_equal(ec.find_in_file(big_path, early_stop=False), got), "a full find after a stop differs")
    out["big_file"] = {"needles": len(needles), "windows_32MiB": windows, "windows_1MiB": small_windows,
                       "early_stop_windows": stopped_at, "launches_per_window": per_window}

    # 3. 4.5 GiB of chunks at 128 MiB windows, never whole on the host.
    plants = make_plants(STREAM_BIG_BYTES)
    plant_needles, exp_first = expected(plants)
    exp_counts = [sum(nd == n for _, n in plants) for nd in plant_needles]
    exp_pos = [np.array(sorted(o for o, n in plants if n == nd), np.int64) for nd in plant_needles]
    block = np.random.default_rng(4545).integers(97, 123, STREAM_BLOCK, dtype=np.uint8)

    def stream():
        return plant_chunks(STREAM_BIG_BYTES, plants, block)

    t0 = time.perf_counter()
    for _ in stream():  # the source alone: a chunk copied, plants written
        pass
    source_s = time.perf_counter() - t0
    sc = StreamingScanner(plant_needles, window_bytes=STREAM_BIG_WINDOW, device=device).warmup()
    for mode, call, exp in (("find", lambda: sc.find_in_chunks(stream(), early_stop=False), exp_first),
                            ("count", lambda: sc.count_in_chunks(stream()), exp_counts),
                            ("positions", lambda: sc.positions_in_chunks(stream()), exp_pos)):
        t0 = time.perf_counter()
        got = call()
        sec = time.perf_counter() - t0
        same = (all(np.array_equal(g, e) for g, e in zip(got, exp)) if mode == "positions"
                else np.array_equal(got, exp))
        check(same, f"4.5 GiB chunk stream: {mode} differs: {got} != {exp}")
        times[f"chunks 4.5 GiB, 128 MiB windows, {mode}"] = {
            "s": sec, "GBps": STREAM_BIG_BYTES / sec / 1e9, "stats": sc.stats_summary()}
    big_windows = sc.stats["windows"]
    check(max(exp_first) > 2**32, "no plant past 2^32")
    win = sc.window
    start = 2**32 - win + 64
    tail = np.zeros(win + 25 + 503, np.uint8)
    tail[win:win + 25] = np.frombuffer(b"xxxxxneedle-in-window-two", np.uint8)
    ts = StreamingScanner([b"needle", b"absent-needle"], window_bytes=win, device=device)
    got = ts.find_in_chunks(iter([tail[:40_000].data, tail[40_000:].data]), early_stop=False, start_offset=start)
    check(got.tolist() == [start + win + 5, -1] and got[0] > 2**32, f"start_offset past 2^32: {got}")
    out["big_chunks"] = {"bytes": STREAM_BIG_BYTES, "windows": big_windows, "plants": len(plants),
                         "first_offsets": exp_first, "start_offset_find": int(got[0]),
                         "chunk_source_alone_s": source_s}

    # 4. Huge needles: the words and the huge phase's i386 needles.
    needles = list(words) + list(i386_huge)
    exp_f = np.concatenate([i386_firsts, [hay.find(nd) for nd in i386_huge]])
    exp_c = np.concatenate([i386_counts, [overlapping_count(hay, nd) for nd in i386_huge]])
    exp_p = list(i386_positions) + [_host_positions(hay, nd) for nd in i386_huge]
    huge = []
    for wb in STREAM_HUGE_WINDOWS:
        sc = StreamingScanner(needles, window_bytes=wb, device=device)
        w = _stream_held(sc, path, exp_f, exp_c, exp_p, f"i386 + huge needles at {wb}-byte windows")
        huge.append({"window_bytes": wb, "window": sc.window, "overlap": sc.overlap, "windows": w})
    check(huge[-1]["window"] == huge[-1]["overlap"], "the window did not grow to the overlap")
    out["huge"] = huge
    say("stream", card=card, cases=out, exact=True)
    return per_window, times, windows


def phase_stream_times(torch, device, card, big, needles, times, windows):
    """Outside the stream path's counts: the card's part of one full
    32 MiB window (CUDA events: the copy of a pinned buffer into a device
    buffer, and the window's find and count launches), a torch.profiler
    trace of one stream of each mode over the 256 MiB file (the card's
    busy and idle share, copies and kernels apart), and the single-layout
    sweeps of the same needles over the corpus already on the card.  Then
    every stream time, each on its own line."""
    import tempfile

    from sliceslice_tpu_torch import BatchedSearcher, DeviceHaystack, StreamingScanner
    from sliceslice_tpu_torch.ops import scan_kernel
    from sliceslice_tpu_torch.scripts.sweep_times import trace_share
    from sliceslice_tpu_torch.utils.profiling import measure

    big_dh, big_hay, _ = big
    sc = StreamingScanner(needles, device=device).warmup()
    host, dev = sc._host_q.queue[0], sc._dev_pool[0]
    h2d = measure(lambda: dev.copy_(host, non_blocking=True), "h2d", samples=5, device=device).estimate
    dh = DeviceHaystack.from_buffer(dev, sc._wcap, sc._kh)
    card_ms = {"h2d_ms": h2d * 1e3, "h2d_GBps": host.numel() / h2d / 1e9}
    for mode, kernel in (("find", scan_kernel.batched_find), ("count", scan_kernel.batched_count)):
        m = measure(lambda k=kernel: sc._group_launches(k, dh, sc._ends_full_dev), f"{mode} window",
                    samples=5, device=device)
        card_ms[f"{mode}_kernels_ms"] = m.estimate * 1e3
        wall = times[f"file 256 MiB, 32 MiB windows, {mode}"]["s"]
        card_ms[f"{mode}_card_share_estimate"] = windows * (h2d + m.estimate) / wall
    groups = {"h2d_copies": "Memcpy HtoD", "find": "batched_find", "count": "count_kernel",
              "bitmap": "match_bitmap", "compaction": "compact_kernel"}
    traced = {}
    with tempfile.TemporaryDirectory() as tmp:
        big_path = os.path.join(tmp, "big.bin")
        with open(big_path, "wb") as f:
            f.write(big_hay)
        for mode, call in (("find", lambda: sc.find_in_file(big_path, early_stop=False)),
                           ("count", lambda: sc.count_in_file(big_path)),
                           ("positions", lambda: sc.positions_in_file(big_path))):
            t = trace_share(torch, call, reps=1, groups=groups)
            traced[mode] = {k: t.get(k) for k in ("device_us", "span_us", "idle_share", "device_events",
                                                  "grouped_us", "note")}
    say("stream_card", card=card, one_window=card_ms, traced_stream=traced)
    single = BatchedSearcher(needles, device=device)
    for mode, call in (("find_all", lambda: single.find_all(big_dh)),
                       ("count_all", lambda: single.count_all(big_dh)),
                       ("positions_all", lambda: single.positions_all(big_dh))):
        m = measure(call, mode, warmup=1, samples=STREAM_SAMPLES)
        times[f"single layout 256 MiB, {mode}"] = {"s": m.estimate, "low_s": m.low,
                                                   "GBps": len(big_hay) / m.estimate / 1e9}
    for what, t in times.items():
        say("stream_time", card=card, what=what, **t)


#: The sharded phase: the meshes of cells on the one card, the 4.5 GiB
#: corpus of the two-process run, its cells per process and its time limit.
SHARDED_MESHES = ((1, 1), (2, 1), (4, 1), (2, 2))
SHARDED_TWO_PROCESS_BYTES = int(4.5 * 2**30)
SHARDED_CELLS_PER_PROCESS = 2
SHARDED_TIMEOUT_S = 400


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _grep_lines(hay: bytes, path: str, backend: str, needles) -> str:
    """The grep CLI's output for ``needles`` under ``backend``, from
    bytes.find (one line a needle, which may hold newlines)."""
    from sliceslice_tpu_torch.searcher import _host_positions, overlapping_count

    def line(nd):
        if backend.endswith("count"):
            return str(overlapping_count(hay, nd))
        if backend.endswith("positions"):
            p = _host_positions(hay, nd)
            more = f" (+{p.size - 100} more)" if p.size > 100 else ""
            return (",".join(map(str, p[:100].tolist())) if p.size else "no match") + more
        f = hay.find(nd)
        return f"match at {f}" if f >= 0 else "no match"

    if backend == "dynamic":  # one needle, not named in its line
        return f"{path}: {line(needles[0])}\n"
    return "".join(f"{path}: {nd.decode()}: {line(nd)}\n" for nd in needles)


def _cli_held(hay: bytes, path: str, runs: dict) -> None:
    """Run ``python -m sliceslice_tpu_torch.cli`` once per entry of
    ``runs`` ({name: (options, backend, needles)}), all at once, and hold
    each exit code and printed output against bytes.find's.  Every process
    is stopped before this returns."""
    import subprocess

    def arg(backend, nds):  # dynamic takes one needle as it is; lists take split_needles' escapes
        if backend == "dynamic":
            return nds[0].decode()
        return ",".join(nd.decode().replace("\\", "\\\\").replace(",", "\\,") for nd in nds)

    procs = {name: subprocess.Popen([sys.executable, "-m", "sliceslice_tpu_torch.cli", *opts, b, arg(b, nds), path],
                                    cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, (opts, b, nds) in runs.items()}
    outs = {}
    try:
        for name, proc in procs.items():
            outs[name] = proc.communicate(timeout=300)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, (opts, b, nds) in runs.items():
        out, err = outs[name]
        rc = procs[name].returncode
        check(rc == (0 if any(hay.find(nd) >= 0 for nd in nds) else 1),
              f"cli {name}: exit code {rc}; stderr: {err[-2000:]}")
        check(out == _grep_lines(hay, path, b, nds), f"cli {name}: printed lines differ from bytes.find's")


def phase_sharded(torch, device, card, hay, words, i386_dh, i386_answers, big, big_answers, i386_huge):
    """Sharded corpora (``parallel/``), each case exact.  (a) NCCL as a
    group of one on the card, meshes 1x1, 2x1, 4x1 and 2x2 of cells on it:
    ``ShardedBatchedSearcher`` find, count and positions of the 4,585
    words over i386 before and after ``optimize_for`` (and with
    ``force_int64``), needles cut across every shard boundary at offsets
    -7..+7, a ``GlobalCorpus`` of i386; at 4x1 the 256 MiB corpus's 41
    needles, the i386 huge needles on the host and the dense tier,
    ``StreamingScanner(mesh=4x1)`` over the 256 MiB file at 32 MiB
    windows, and the CLI's sharded backends at --mesh 4x1 and 2x2.  Then
    the group is destroyed.  (b) gloo across two processes on the card:
    ``scripts/multihost_check.py --device cuda`` over a 4.5 GiB corpus, each
    process holding its 2.25 GiB half as 2 cells (a 4x1 mesh), exact past
    2^31 and 2^32 and across the process boundary."""
    import subprocess
    import tempfile

    import torch.distributed as dist

    from sliceslice_tpu_torch import BatchedSearcher, StreamingScanner, overlapping_count
    from sliceslice_tpu_torch.models import huge as huge_mod
    from sliceslice_tpu_torch.parallel import ShardedBatchedSearcher, make_mesh
    from sliceslice_tpu_torch.parallel.distributed import all_reduce, assemble_global_corpus, initialize
    from sliceslice_tpu_torch.parallel.shard_scan import shard_bytes_for
    from sliceslice_tpu_torch.searcher import _host_positions

    i386_firsts, i386_counts, i386_positions = i386_answers
    big_dh, big_hay, _ = big
    big_needles, big_firsts, big_counts, big_positions = big_answers
    out = {"meshes": {}}

    def held(sb, dh, firsts, counts, positions, what):
        f, c, p = sb.find_all(dh), sb.count_all(dh), sb.positions_all(dh)
        check(f.dtype == np.int64 and np.array_equal(f, firsts), f"{what}: find_all differs "
              f"({int((f != np.asarray(firsts)).sum())} needles)")
        check(np.array_equal(c, counts), f"{what}: count_all differs ({int((c != np.asarray(counts)).sum())})")
        bad = sum(not np.array_equal(g, e) for g, e in zip(p, positions))
        check(len(p) == len(positions) and bad == 0, f"{what}: positions_all differs ({bad} needles)")

    initialize(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl", device=device, timeout_s=300)
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1, "not an NCCL group of one")
        calls0 = all_reduce.calls
        for shape in SHARDED_MESHES:
            mesh = make_mesh(shape, device=device)
            sb = ShardedBatchedSearcher(words, mesh)
            held(sb, i386_dh, i386_firsts, i386_counts, i386_positions, f"i386 at {shape}")
            sb.optimize_for(i386_dh)
            held(sb, i386_dh, i386_firsts, i386_counts, i386_positions, f"i386 at {shape} after optimize_for")
            wide = ShardedBatchedSearcher(words, mesh)
            wide.force_int64 = True
            check(np.array_equal(wide.find_all(i386_dh), i386_firsts)
                  and np.array_equal(wide.count_all(i386_dh), i386_counts), f"i386 at {shape}: force_int64 differs")
            shard = shard_bytes_for(len(hay), shape[0])
            cuts = [hay[b * shard + o:b * shard + o + 12] for b in range(1, shape[0]) for o in range(-7, 8)]
            if cuts:
                cut = ShardedBatchedSearcher(cuts, mesh)
                exp_f = [hay.find(nd) for nd in cuts]
                exp_c = [overlapping_count(hay, nd) for nd in cuts]
                held(cut, i386_dh, exp_f, exp_c, [_host_positions(hay, nd) for nd in cuts],
                     f"shard-boundary needles at {shape}")
            gc = assemble_global_corpus(hay, b"", len(hay), 24, mesh)
            held(sb, gc, i386_firsts, i386_counts, i386_positions, f"a GlobalCorpus of i386 at {shape}")
            out["meshes"][f"{shape[0]}x{shape[1]}"] = {"cells": shape[0] * shape[1], "shard_bytes": shard,
                                                       "boundary_needles": len(cuts)}
        mesh4 = make_mesh((4, 1), device=device)
        held(ShardedBatchedSearcher(big_needles, mesh4), big_dh, big_firsts, big_counts, big_positions,
             "the 256 MiB corpus at 4x1")
        # The i386 huge needles among a few words: the host tier, then the
        # dense tier (its candidate budget set to 0).
        needles = list(i386_huge) + list(words[::500])
        exp = ([hay.find(nd) for nd in needles], [overlapping_count(hay, nd) for nd in needles],
               [_host_positions(hay, nd) for nd in needles])
        tiers = {}
        for tier, budget in (("host", huge_mod.HOST_VERIFY_MAX), ("dense", 0)):
            saved, huge_mod.HOST_VERIFY_MAX = huge_mod.HOST_VERIFY_MAX, budget
            try:
                hsb = ShardedBatchedSearcher(needles, mesh4)
                held(hsb, i386_dh, *exp, f"i386 huge needles at 4x1, {tier} tier")
                held(hsb, assemble_global_corpus(hay, b"", len(hay), 64, mesh4), *exp,
                     f"i386 huge needles over a GlobalCorpus at 4x1, {tier} tier")
            finally:
                huge_mod.HOST_VERIFY_MAX = saved
            tiers[tier] = len(i386_huge)
        # A stream over the 4x1 mesh: the 256 MiB corpus as a file.
        with tempfile.TemporaryDirectory() as tmp:
            big_path = os.path.join(tmp, "big.bin")
            with open(big_path, "wb") as f:
                f.write(big_hay)
            sc = StreamingScanner(big_needles, mesh=mesh4, device=device)
            windows = _stream_held(sc, big_path, big_firsts, big_counts, big_positions, "256 MiB over a 4x1 mesh")
        # The CLI's sharded backends, six processes at once.
        path = "data/i386.txt"
        lists = {"sharded": [b"Protected Mode", b"zebra!", b"the"], "sharded-count": [b"the", b"zebra!"],
                 "sharded-positions": [b"Protected Mode", b"zebra!"]}
        runs = {f"{b} --mesh {m}": (["--mesh", m], b, nds) for b, nds in lists.items() for m in ("4x1", "2x2")}
        _cli_held(hay, path, runs)
        out.update(collectives_in_a=all_reduce.calls - calls0, huge_tiers=tiers, stream_windows=windows,
                   cli=list(runs))
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the NCCL group outlived the phase")

    # (b) gloo across two processes on the card, 4.5 GiB.
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sliceslice_tpu_torch.scripts.multihost_check", "--device", "cuda",
         "--bytes", str(SHARDED_TWO_PROCESS_BYTES), "--cells-per-process", str(SHARDED_CELLS_PER_PROCESS),
         "--timeout", str(SHARDED_TIMEOUT_S - 20)],
        cwd=REPO, capture_output=True, text=True, timeout=SHARDED_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0 and "2-process sharded scan parity ok" in proc.stdout,
          f"the two-process run failed (rc={proc.returncode}): {(proc.stdout + proc.stderr)[-3000:]}")
    workers = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    check(len(workers) == 2 and all(w["max_offset"] > 2**32 for w in workers),
          "the two-process run held no plant past 2^32")
    out["two_processes"] = {"wall_s": wall, "workers": workers}
    say("sharded", card=card, cases=out, exact=True)
    return out


def phase_sharded_times(torch, device, card, words, i386_dh, big):
    """Outside the sharded path's counts: the i386 find and count sweeps
    through ``ShardedBatchedSearcher`` at 1x1, 2x1, 4x1 and 2x2 against
    ``BatchedSearcher``'s, with their host stages, with no group, in an
    NCCL group of one and with no group again (``sweep_times.py
    --sharded``), the µs of one NCCL collective of 4,585 int64,
    ``measure_scaling``'s table over 1, 2 and 4 cells on the card (what a
    mesh costs there, not scaling), the launches of one sweep at 4x1, and
    the count kernel's one-row rate over the 256 MiB corpus
    (``predicted_efficiency``'s default)."""
    import torch.distributed as dist

    from sliceslice_tpu_torch import BatchedSearcher
    from sliceslice_tpu_torch.needle import build_probe_table
    from sliceslice_tpu_torch.ops import scan_kernel
    from sliceslice_tpu_torch.ops.scan_math import table_bits
    from sliceslice_tpu_torch.parallel import ShardedBatchedSearcher, format_report, make_mesh, measure_scaling
    from sliceslice_tpu_torch.parallel.distributed import all_reduce, initialize
    from sliceslice_tpu_torch.scripts.sweep_times import sharded_rounds
    from sliceslice_tpu_torch.utils.profiling import measure

    bs = BatchedSearcher(words, device=device).optimize_for(i386_dh)
    rounds = sharded_rounds(torch, bs, words, i386_dh, device)
    sb4 = ShardedBatchedSearcher(words, make_mesh((4, 1), device=device)).optimize_for(i386_dh)
    initialize(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl", device=device, timeout_s=300)
    try:
        vec = torch.zeros((len(words),), dtype=torch.int64, device=device)
        m = measure(lambda: [all_reduce(vec, "min") for _ in range(SWEEPS)], "nccl all_reduce", warmup=1,
                    samples=5, device=device)
        nccl_us = m.estimate * 1e6 / SWEEPS
        c0 = all_reduce.calls
        sb4.find_all(i386_dh)
        per_sweep_collectives = all_reduce.calls - c0
    finally:
        dist.destroy_process_group()
    names = {"batched_find": "batched_find", "batched_count": "batched_count",
             "match_bitmap": "match_bitmap_counted", "item_ranks": "item_ranks",
             "compact_window": "compact_window"}
    per_sweep = {}
    for run in (lambda: sb4.find_all(i386_dh), lambda: sb4.count_all(i386_dh), lambda: sb4.positions_all(i386_dh)):
        before = {k: counter("launches." + w) for k, w in names.items()}
        run()
        per_sweep.update({k: counter("launches." + w) - before[k] for k, w in names.items() if counter("launches." + w) > before[k]})
    scaling = measure_scaling(i386_dh, words, device_counts=[1, 2, 4], samples=5)
    # The count kernel's one-row rate over 256 MiB (an absent needle: every
    # position tested).
    big_dh, big_hay, _ = big
    nd = bytes([255]) + big_hay[1000:1010]
    vals, msks, lens = build_probe_table([nd])
    v, m_, e = (table_bits(vals, device), table_bits(msks, device),
                torch.tensor([len(big_hay) - len(nd) + 1], dtype=torch.int32, device=device))
    one = measure(lambda: [scan_kernel.batched_count(big_dh.flat, v, m_, e) for _ in range(SWEEPS)],
                  "one-row count, 256 MiB", warmup=1, samples=5, device=device)
    one_ms = one.estimate * 1e3 / SWEEPS
    for row in rounds:
        say("sharded_times", card=card, **row)
    say("sharded_times", card=card, nccl_all_reduce_us=nccl_us, collectives_per_sweep=per_sweep_collectives,
        launches_per_sweep_4x1=per_sweep, groups=len(sb4.inner.groups), one_row_count_ms_256MiB=one_ms,
        one_row_count_GBps=len(big_hay) / (one_ms * 1e-3) / 1e9,
        scaling_note="cells on one card: dispatch overhead, not scaling", scaling=scaling)
    print("measure_scaling over cells on one card (dispatch overhead, not scaling), " + card)
    print(format_report(scaling))
    return per_sweep


def phase_cli(hay):
    """``python -m sliceslice_tpu_torch.cli`` over data/i386.txt with the
    dynamic, batched, count, positions, stream, stream-count and
    stream-positions backends, a huge needle among the needles, in seven
    processes at once; every printed line against lines built from
    bytes.find."""
    path = "data/i386.txt"
    huge = _ascii_slice(hay, 300_000, 4096)
    huge2 = _ascii_slice(hay, 500_000, 2049)
    absent = huge2[:1000] + (b"~" if huge2[1000:1001] != b"~" else b"^") + huge2[1001:]
    short = [b"Protected Mode", b"zebra!", b"the"]
    lists = {"batched": [short[0], huge, absent, short[1]], "count": [short[2], huge2, absent],
             "positions": [short[2], huge, absent]}
    for backend in list(lists):  # the same lists, streamed
        lists["stream" if backend == "batched" else f"stream-{backend}"] = lists[backend]
    runs = {b: ([], b, nds) for b, nds in {"dynamic": [huge], **lists}.items()}
    _cli_held(hay, path, runs)
    say("cli", backends=list(runs), needle_lengths={b: [len(nd) for nd in nds] for b, (_, _, nds) in runs.items()},
        lines={b: len(nds) for b, (_, _, nds) in runs.items()}, equal_to_bytes_find=True)


#: Rounds of the fuzz campaign in the harness phase (4 rounds took 1.4 s on
#: an H100, PERF.md; the campaign is held well under 60 s), and the bytes of
#: the bench's stream rows there (the 1 GiB rows run outside the smoke).
HARNESS_FUZZ_ROUNDS = 24
HARNESS_STREAM_BYTES = 256 << 20


def _captured(fn, *args, **kwargs):
    """(result, printed text, seconds) of one call, its output echoed."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    sec = time.perf_counter() - t0
    text = buf.getvalue()
    print(text, end="", flush=True)
    return out, text, sec


def phase_harness(torch, device, card, i386_firsts, pair_exp):
    """The port's harness on the card, each part exact and timed: the full
    conformance run (4,585 words over i386 and 21,022,225 pairs, against
    the host oracles the find and pairwise phases built), the fuzz
    campaign (:data:`HARNESS_FUZZ_ROUNDS` rounds, seed 20260818), the
    random size matrix, one ``bench.main`` at full size (its detail and
    last line printed here, earlier than the smoke's last line; its
    stream rows over :data:`HARNESS_STREAM_BYTES`), then ``breakeven``,
    ``oneshot_decompose`` and ``perf_long`` once each."""
    from sliceslice_tpu_torch import bench
    from sliceslice_tpu_torch.benchmarks import random_matrix
    from sliceslice_tpu_torch.scripts import breakeven, conformance, fuzz_campaign, oneshot_decompose, perf_long

    conf, _, sec = _captured(conformance.run_conformance, full=True, device=device, exp_long=i386_firsts,
                             exp_short=pair_exp)
    check(conf["long_words"] == 4585 and conf["short_total_checked"] == 21_022_225, f"conformance: {conf}")
    check(conf["long_mismatches"] == 0 and conf["short_mismatches"] == 0, f"conformance mismatches: {conf}")
    say("harness", part="conformance", seconds=round(sec, 3), **conf)

    rc, text, sec = _captured(fuzz_campaign.main, [str(HARNESS_FUZZ_ROUNDS), "20260818", "--device", str(device)])
    summary = text.strip().splitlines()[-1]
    check(rc == 0 and "MISMATCH" not in text, f"fuzz campaign failed: {summary}")
    say("harness", part="fuzz_campaign", rounds=HARNESS_FUZZ_ROUNDS, seconds=round(sec, 3), summary=summary)

    rows, _, sec = _captured(random_matrix.collect, device)
    check(len(rows) == 28, f"random matrix: {len(rows)} cells, not 28")
    say("harness", part="random_matrix", cells=len(rows), exact=True, seconds=round(sec, 3))

    rc, text, sec = _captured(bench.main, ["--device", str(device), "--stream-bytes", str(HARNESS_STREAM_BYTES)],
                              oracle=(i386_firsts, pair_exp))
    last = json.loads(text.strip().splitlines()[-1])
    check(rc == 0 and set(last) == {"metric", "value", "unit", "vs_baseline"} and last["value"] > 0
          and card.split(",")[0] in last["metric"], f"bench failed: {last}")
    say("harness", part="bench", seconds=round(sec, 3), gbps=last["value"], vs_baseline=last["vs_baseline"])

    for script in (breakeven, oneshot_decompose, perf_long):
        rc, _, sec = _captured(script.main, ["--device", str(device)])
        check(rc == 0, f"{script.__name__} failed")
        say("harness", part=script.__name__.rsplit(".", 1)[-1], seconds=round(sec, 3))


def phase_count(torch, device, hay, words, i386_dh, big):
    """Counts on the count path: all words over i386 before and after
    optimize_for, DynamicSearcher.count_in on every arm, and the 256 MiB
    corpus's planted needles and one periodic needle."""
    from sliceslice_tpu_torch import BatchedSearcher, DynamicSearcher, overlapping_count, preprocess

    t0 = time.perf_counter()
    exp = np.array([overlapping_count(hay, w) for w in words])
    oracle_s = time.perf_counter() - t0
    bs = BatchedSearcher(words, device=device)
    got = bs.count_all(i386_dh)
    check(np.array_equal(got, exp), f"i386 counts: {int((got != exp).sum())} words differ")
    bs.optimize_for(i386_dh)
    got = bs.count_all(i386_dh)
    check(np.array_equal(got, exp), "i386 counts after optimize_for differ")

    rng = np.random.default_rng(11)
    small = hay[100_000:106_000]            # bytes, 4096 < len <= 8192: host count
    # A flat rung on the card, with no host bytes: it is counted on the
    # card, re-laid into the kernel layout there.
    tiny = preprocess(hay[:3000], keep_host=False, device=device)
    check(not tiny.tiled, "the 3,000-byte layout is not the flat rung")
    flat_words = words[::15]
    c0 = counter("launches.batched_count")
    flat_bs = BatchedSearcher(flat_words, device=device)
    got = flat_bs.count_all(tiny)
    check(np.array_equal(got, [overlapping_count(hay[:3000], w) for w in flat_words]),
          "counts over the flat rung on the card differ")
    check(counter("launches.batched_count") == c0 + len(flat_bs.groups),
          "count_all over the flat rung on the card did not launch the count kernel per group")
    lengths = [0, 1, 2, 3, 5, 8, 12, 16, 17, 24, 32, 33, 40, 100, 1000]
    checks = 0
    c0 = counter("launches.batched_count")
    for k in lengths:
        for h_bytes, h in ((small, small), (hay[:3000], tiny), (hay, i386_dh), (hay, hay)):
            start = int(rng.integers(0, len(h_bytes) - k))
            for nd in (h_bytes[start:start + k], h_bytes[-k:] if k else b"", b"\xfe" * k):
                before = counter("launches.batched_count")
                got = DynamicSearcher(nd, device=device).count_in(h)
                check(got == overlapping_count(h_bytes, nd), f"DynamicSearcher.count_in k={k} differs")
                if k and h is tiny:
                    check(counter("launches.batched_count") == before + 1,
                          f"count_in k={k} over the flat rung on the card did not launch the count kernel")
                checks += 1
        if k == 1:
            check(counter("launches.batched_count") > c0, "the 1-byte arm never launched the count kernel")

    big_dh, big_hay, big_needles = big
    periodic = BIG_PERIODIC
    needles = big_needles + [periodic]
    exp_big = np.array([overlapping_count(big_hay, nd) for nd in needles])
    check(exp_big[-1] == 1000 - 2, "periodic run not planted")
    got = BatchedSearcher(needles, device=device).count_all(big_dh)
    check(np.array_equal(got, exp_big), f"256 MiB counts: {int((got != exp_big).sum())} needles differ")
    check(DynamicSearcher(periodic, device=device).count_in(big_dh) == exp_big[-1],
          "256 MiB corpus: periodic count differs")
    say("count", words=len(words), total_i386_matches=int(exp.sum()), host_oracle_s=round(oracle_s, 3),
        parity=True, parity_after_optimize_for=True, flat_rung_words=len(flat_words),
        dynamic_lengths=lengths, dynamic_checks=checks,
        big_needles=len(needles), big_total_matches=int(exp_big.sum()))
    return bs, exp, exp_big


def phase_positions(torch, device, hay, words, i386_dh, big, i386_counts, big_counts):
    """Positions on the positions path: all words over i386 before and
    after optimize_for (rows past the sparse cap and under it, every row
    compacted on the card, no bitmap decoded on the host),
    DynamicSearcher.positions on every arm, a flat layout on the card kept
    without host bytes, and the 256 MiB corpus's needles and periodic run;
    totals against the count phase."""
    from sliceslice_tpu_torch import BatchedSearcher, DynamicSearcher, preprocess
    from sliceslice_tpu_torch.ops import torch_backend
    from sliceslice_tpu_torch.searcher import _host_positions

    cap = torch_backend.SPARSE_POSITIONS_CAP
    t0 = time.perf_counter()
    exp = [_host_positions(hay, w) for w in words]
    oracle_s = time.perf_counter() - t0
    bs = BatchedSearcher(words, device=device)

    def same(got, exp_rows, what):
        bad = sum(not np.array_equal(g, e) for g, e in zip(got, exp_rows))
        check(len(got) == len(exp_rows) and bad == 0, f"{what}: {bad} rows differ")

    def launches():
        return (counter("launches.match_bitmap_counted"), counter("launches.item_ranks"),
                counter("launches.compact_window"))

    def sweep_launches(searcher, exp_rows):
        """A bitmap and a rank launch per width group (one launch batch
        each), a compaction launch per group holding a match (one window)."""
        live = sum(any(exp_rows[j].size for j in g.indices.tolist()) for g in searcher.groups)
        return len(searcher.groups), len(searcher.groups), live

    before = launches()
    decode = torch_backend.decode_match_bitmap
    torch_backend.decode_match_bitmap = None  # the positions path decodes nothing on the host
    try:
        got = bs.positions_all(i386_dh)
    finally:
        torch_backend.decode_match_bitmap = decode
    made = tuple(a - b for a, b in zip(launches(), before))
    same(got, exp, "i386 positions")
    check(made == sweep_launches(bs, exp),
          f"i386 positions sweep: {made} bitmap, rank and compaction launches, "
          f"not {sweep_launches(bs, exp)} ({len(bs.groups)} width groups)")
    total = sum(len(p) for p in got)
    dense = sum(len(p) > cap for p in got)
    i386_total = int(i386_counts.sum())
    check(total == i386_total, f"i386 positions total {total} != count total {i386_total}")
    check(0 < dense < len(words), f"i386 positions: {dense} dense rows, no row on one tier")
    bs.optimize_for(i386_dh)
    same(bs.positions_all(i386_dh), exp, "i386 positions after optimize_for")

    rng = np.random.default_rng(13)
    small = hay[100_000:106_000]            # bytes, 4096 < len <= 8192: host positions
    tiny = preprocess(hay[:3000], keep_host=False, device=device)   # flat rung, card only
    check(not tiny.tiled, "the 3,000-byte layout is not the flat rung")
    flat_words = words[::15]
    flat_exp = [_host_positions(hay[:3000], w) for w in flat_words]
    before = launches()
    flat_bs = BatchedSearcher(flat_words, device=device)
    same(flat_bs.positions_all(tiny), flat_exp, "positions over the flat rung on the card")
    check(tuple(a - b for a, b in zip(launches(), before)) == sweep_launches(flat_bs, flat_exp),
          "positions_all over the flat rung on the card did not launch the bitmap, rank and "
          "compaction kernels")
    lengths = [0, 1, 2, 3, 5, 8, 12, 16, 17, 24, 32, 33, 40, 100, 1000]
    checks = 0
    for k in lengths:
        for h_bytes, h in ((small, small), (hay[:3000], tiny), (hay, i386_dh), (hay, hay)):
            start = int(rng.integers(0, len(h_bytes) - k))
            for nd in (h_bytes[start:start + k], h_bytes[-k:] if k else b"", b"\xfe" * k,
                       h_bytes[len(h_bytes) - k + 1:] + b"\0" if k else b""):
                before = launches()
                got = DynamicSearcher(nd, device=device).positions(h)
                check(np.array_equal(got, _host_positions(h_bytes, nd)),
                      f"DynamicSearcher.positions k={k} differs")
                if k and h is tiny:
                    check(tuple(a - b for a, b in zip(launches(), before)) == (1, 1, int(got.size > 0)),
                          f"positions k={k} over the flat rung on the card did not launch the "
                          "bitmap, rank and compaction kernels")
                checks += 1

    big_dh, big_hay, big_needles = big
    periodic = BIG_PERIODIC
    needles = big_needles + [periodic]
    t0 = time.perf_counter()
    exp_big = [_host_positions(big_hay, nd) for nd in needles]
    oracle_s += time.perf_counter() - t0
    got = BatchedSearcher(needles, device=device).positions_all(big_dh)
    same(got, exp_big, "256 MiB positions")
    sizes = np.array([len(p) for p in got])
    check(np.array_equal(sizes, big_counts), "256 MiB positions totals != the count phase's counts")
    check(np.array_equal(DynamicSearcher(periodic, device=device).positions(big_dh), exp_big[-1]),
          "256 MiB corpus: periodic positions differ")
    say("positions", words=len(words), total_i386_matches=total, dense_rows=dense,
        sparse_cap=cap, sweep_bitmap_launches=made[0], sweep_rank_launches=made[1],
        sweep_compaction_launches=made[2], width_groups=len(bs.groups), parity=True, parity_after_optimize_for=True,
        flat_rung_words=len(flat_words), dynamic_lengths=lengths, dynamic_checks=checks,
        big_needles=len(needles), big_total_matches=int(sizes.sum()),
        big_dense_rows=int((sizes > cap).sum()), host_oracle_s=round(oracle_s, 3))
    return bs, exp, exp_big


def phase_contracts(torch, device):
    """The probe-table contract cases (``scripts/contract_cases.py``: the
    mixed-width table the JAX package's ``*_cols`` refuse, a final mask of
    0xFFFF0000, a prefix mask): the find, count, bitmap and compaction
    kernels against their plain versions and the host oracles
    (``bytes.find``, ``overlapping_count``, the host scan; a regular
    expression for the caller-built row), and the exotic table through a
    2x1 sharded sweep of cells on the card."""
    from sliceslice_tpu_torch.config import SENTINEL
    from sliceslice_tpu_torch.parallel import make_mesh, sharded_find_cols
    from sliceslice_tpu_torch.scripts import contract_cases as cc

    answers = {}
    for case in cc.cases():
        dh, v, m, e = cc.operands(case, device)
        got = cc.answers(dh.flat, v, m, e)
        check(cc.same(got, cc.answers(dh.flat, v, m, e, plain=True)),
              f"contracts {case.name}: the kernels differ from their plain versions")
        check(cc.same(got, cc.oracle(case)), f"contracts {case.name}: the kernels differ from the host oracles")
        answers[case.name] = {"firsts": got[0], "counts": got[1], "positions": [p.tolist() for p in got[2]]}
        if case.name == "exotic_mask":
            sharded = sharded_find_cols(dh, case.values, case.masks, case.ends, make_mesh((2, 1), device=device))
            sharded = [-1 if f >= SENTINEL else f for f in sharded.tolist()]
            check(sharded == got[0], f"contracts: the 2x1 sharded sweep gave {sharded}, not {got[0]}")
            answers[case.name]["sharded_2x1_firsts"] = sharded
    say("contracts", answers=answers, parity=True)


def phase_probe(torch, device, hay, i386_dh, count_bs):
    """Every variant of the ablation kernel at t = 1, 2, 3 over the JAX
    harness's tables (4,585 rows over i386): equal to its plain version,
    the answer-preserving ones to the count and find kernels, the planted
    rows (t=2) at their bytes.find offsets.  Then the counting variants over
    the real words' tables (every width group): equal to the count kernel,
    so the prefilter's candidates lose no match."""
    from sliceslice_tpu_torch import overlapping_count, preprocess
    from sliceslice_tpu_torch.config import SENTINEL
    from sliceslice_tpu_torch.needle import needed_halo_for_t
    from sliceslice_tpu_torch.ops import scan_kernel
    from sliceslice_tpu_torch.ops.scan_math import table_bits
    from sliceslice_tpu_torch.scripts import kernel_probe as kp

    n = 4585
    dh = preprocess(hay, kh=needed_halo_for_t(max(PROBE_TS)), device=device)
    err, setups, plants = 0, {}, []
    for t in PROBE_TS:
        values, masks = kp.make_tables(hay, t, n)
        v, m = table_bits(values, device), table_bits(masks, device)
        e = torch.from_numpy(kp.table_ends(masks, len(hay))).to(device)
        count = scan_kernel.batched_count(dh.flat, v, m, e, n_real=n)
        first = scan_kernel.batched_find(dh.flat, v, m, e, n_real=n)
        for variant in kp.VARIANTS:
            got = kp.probe(variant, dh.flat, v, m, e, n_real=n)
            plain = kp.probe_plain(variant, dh.flat, v, m, e, n_real=n)
            err = max(err, int((got.long() - plain.long()).abs().max()))
            check(torch.equal(got, plain), f"probe kernel != plain: {variant}, t={t}")
            if variant in kp.COUNTING:
                check(torch.equal(got, count), f"probe {variant} != batched_count at t={t}")
            elif variant == "first":
                check(torch.equal(got, first), f"probe first != batched_find at t={t}")
            elif variant == "nomin":
                check(torch.equal(got, (first != SENTINEL).to(torch.int32)),
                      f"probe nomin != batched_find != SENTINEL at t={t}")
        if t == 2:
            for row, nd in kp.planted(hay, masks).items():
                check(int(first[row]) == hay.find(nd) and int(count[row]) == overlapping_count(hay, nd),
                      f"planted row {row} not at its bytes.find offset")
                plants.append((row, int(first[row]), int(count[row])))
        setups[t] = (dh.flat, v, m, e, n)
    real = 0
    for g in count_bs.groups:
        call = (i386_dh.flat, g.values_dev, g.masks_dev, g.ends_dev(i386_dh.length), 0, g.n)
        count = scan_kernel.batched_count(*call)
        for variant in kp.COUNTING:
            got = kp.probe(variant, *call)
            err = max(err, _err(got, count))
            check(torch.equal(got, count), f"probe {variant} != batched_count on the real words, t={g.t}")
        real += g.n
    say("probe", rows=n, widths=list(PROBE_TS), variants=list(kp.VARIANTS), max_abs_err=err,
        equal_to_plain=True, counting_equal_batched_count=True, first_equal_batched_find=True,
        planted_rows_first_count=plants, real_word_rows=real,
        real_word_widths=[g.t for g in count_bs.groups])
    return err, setups


def phase_pairwise(torch, device, words):
    """All 21,022,225 pairs of the length-sorted words, as bench.py sorts
    them, against bytes.find."""
    from sliceslice_tpu_torch import PairwiseSearcher
    from sliceslice_tpu_torch.scripts.conformance import pair_oracle

    ws = sorted(words, key=len)
    t0 = time.perf_counter()
    exp = pair_oracle(ws)
    oracle_s = time.perf_counter() - t0
    ps = PairwiseSearcher(ws, device=device)
    first = ps.first_matrix()
    check(np.array_equal(first, exp), f"pair sweep: {int((first != exp).sum())} pairs' first differ")
    contains = ps.contains_matrix()
    check(np.array_equal(contains, exp >= 0), "pair sweep: contains differs")
    total = int(ps.count_matches_device())
    check(total == int(contains.sum()), "pair sweep: count_matches_device != contains.sum()")
    # The cached launch plan: a repeated sweep is one launch, no upload.
    made, sent = counter("launches.pair_block"), counter("uploads.pair_block")
    totals = [ps.count_matches_device() for _ in range(SWEEPS)]
    made, sent = counter("launches.pair_block") - made, counter("uploads.pair_block") - sent
    check(made == SWEEPS, f"{SWEEPS} count_matches_device calls made {made} launches")
    check(sent == 0, f"{SWEEPS} count_matches_device calls uploaded {sent} plans")
    check({int(x) for x in totals} == {total}, "pair sweep: repeated counts differ")
    plan = ps._plan(None)
    say("pairwise", words=len(ws), pairs=exp.size, matches=total,
        plan_blocks=len(plan), skipped_blocks=sum(1 for e in plan if e[2] == 0),
        repeated_sweeps=SWEEPS, repeated_launches=SWEEPS, repeated_plan_uploads=0,
        host_oracle_s=round(oracle_s, 3), parity=True)
    return ps, exp


def phase_times(torch, device, card, i386_dh, bs, big_dh, count_bs, ps, pos_bs, probe_setups):
    from sliceslice_tpu_torch.ops import pairwise, scan_kernel, torch_backend
    from sliceslice_tpu_torch.scripts import kernel_probe as kp
    from sliceslice_tpu_torch.utils.profiling import HBM_ROOFLINE, measure

    n_words, hay_len = len(bs), i386_dh.length

    def sweeps():
        for _ in range(SWEEPS):
            bs.find_all_device(i386_dh)

    m = measure(sweeps, f"i386 sweep x{SWEEPS}", warmup=1, samples=5,
                bytes_processed=n_words * hay_len * SWEEPS, device=device)
    per_sweep_ms = m.estimate * 1e3 / SWEEPS
    say("times", what="sustained i386 sweep", card=card, sweeps=SWEEPS,
        ms_per_sweep=per_sweep_ms, low_ms=m.low * 1e3 / SWEEPS,
        high_ms=m.high * 1e3 / SWEEPS,
        effective_GBps=m.gbps(), effective_GBps_means="words x corpus bytes / time")

    def group_calls(searcher):
        return [(i386_dh.flat, g.values_dev, g.masks_dev, g.ends_dev(hay_len), 0, g.n)
                for g in searcher.groups]

    def vs_plain(kernel, plain, calls, what, samples=5, **fields):
        p = measure(lambda: [plain(*c) for c in calls], f"{what} plain", warmup=1, samples=3,
                    device=device)
        k = measure(lambda: [kernel(*c) for c in calls], f"{what} kernel", warmup=1,
                    samples=samples, device=device)
        kern_ms, plain_ms = k.estimate * 1e3, p.estimate * 1e3
        say("times", what=what, card=card, kernel_ms=kern_ms, plain_ms=plain_ms,
            speedup=plain_ms / kern_ms, **fields)
        return kern_ms, plain_ms

    find = vs_plain(scan_kernel.batched_find, scan_kernel.batched_find_plain, group_calls(bs),
                    "find kernel vs plain, one i386 sweep (all width groups)")

    big_end = big_dh.length
    mem_plain = measure(lambda: scan_kernel.memchr_find_plain(big_dh.flat, 255, big_end),
                        "memchr plain", warmup=1, samples=3, device=device)
    mem = measure(lambda: scan_kernel.memchr_find(big_dh.flat, 255, big_end),
                  "memchr kernel", warmup=1, samples=5, bytes_processed=big_end,
                  device=device)
    mem_ms, mem_plain_ms = mem.estimate * 1e3, mem_plain.estimate * 1e3
    say("times", what="memchr kernel vs plain, absent byte over 256 MiB (full scan)",
        card=card, kernel_ms=mem_ms, plain_ms=mem_plain_ms,
        kernel_GBps=mem.gbps(), hbm_roofline_GBps=HBM_ROOFLINE["h100"] / 1e9,
        roofline_share=mem.gbps() * 1e9 / HBM_ROOFLINE["h100"])

    def count_sweeps():
        for _ in range(SWEEPS):
            count_bs.count_all_device(i386_dh)

    m = measure(count_sweeps, f"i386 count sweep x{SWEEPS}", warmup=1, samples=5,
                bytes_processed=n_words * hay_len * SWEEPS, device=device)
    say("times", what="sustained i386 count sweep (after optimize_for)", card=card,
        sweeps=SWEEPS, ms_per_sweep=m.estimate * 1e3 / SWEEPS, low_ms=m.low * 1e3 / SWEEPS,
        high_ms=m.high * 1e3 / SWEEPS, positions_per_s=m.gbps() * 1e9,
        positions_per_s_means="words x corpus bytes / time")
    count = vs_plain(scan_kernel.batched_count, scan_kernel.batched_count_plain,
                     group_calls(count_bs), "count kernel vs plain, one i386 sweep (all width groups)",
                     groups={g.t: g.n for g in count_bs.groups})

    def pair_sweeps():
        for _ in range(SWEEPS):
            ps.count_matches_device()

    n_pairs = len(ps.needles) ** 2
    m = measure(pair_sweeps, f"pair sweep x{SWEEPS}", warmup=1, samples=5, device=device)
    say("times", what="sustained all-pairs sweep (count_matches_device)", card=card,
        sweeps=SWEEPS, pairs=n_pairs, ms_per_sweep=m.estimate * 1e3 / SWEEPS,
        low_ms=m.low * 1e3 / SWEEPS, high_ms=m.high * 1e3 / SWEEPS,
        pairs_per_s=n_pairs * SWEEPS / m.estimate)
    # The pair kernel alone: launches queued behind a spin kernel, so the
    # card runs them back to back (device time, each with its small fills);
    # then the wrapper's call on the cached launch plan, as the sweep makes
    # it, and pair_block with a host plan, checked and uploaded per call.
    from sliceslice_tpu_torch.scripts import sweep_times

    pk, lh, _, _ = ps._pack_hay(None)
    args = (ps._values, ps._masks, ps._ln, pk, lh, ps._plan(None), ps.block)
    pair_device = {
        "count_mode": sweep_times.device_ms(torch, ps.count_matches_device, SWEEPS),
        "matrix_mode": sweep_times.device_ms(
            torch, lambda: pairwise.run_launch(ps._launch_plan(None)), SWEEPS)}
    say("times", what="pair kernel device time, one all-pairs sweep (ms: low, median, high; "
        f"{SWEEPS} launches behind a spin kernel between two CUDA events)", card=card,
        pairs=n_pairs, **pair_device)
    launch = ps._launch_plan(None)
    matrix = measure(lambda: pairwise.run_launch(launch), "pair kernel, matrix mode", warmup=1,
                     samples=5, device=device)
    direct = measure(lambda: pairwise.pair_block(*args, count=True), "pair_block, host plan", warmup=1,
                     samples=5, device=device)
    pair = vs_plain(lambda lp: pairwise.run_launch(lp, count=True),
                    lambda lp: pairwise._pair_blocks_plain(*lp.operands, lp.live.tolist(), lp.block, True),
                    [(launch,)], "pair kernel vs plain, count mode, one all-pairs sweep on its cached launch plan",
                    matrix_mode_kernel_ms=matrix.estimate * 1e3,
                    pair_block_with_a_host_plan_ms=direct.estimate * 1e3)

    def pos_sweeps():
        for _ in range(POSITION_SWEEPS):
            pos_bs.positions_all(i386_dh)

    m = measure(pos_sweeps, f"i386 positions sweep x{POSITION_SWEEPS}", warmup=1, samples=3,
                device=device)
    say("times", what="sustained i386 positions sweep (positions_all, default batches, after optimize_for)",
        card=card, sweeps=POSITION_SWEEPS, ms_per_sweep=m.estimate * 1e3 / POSITION_SWEEPS,
        low_ms=m.low * 1e3 / POSITION_SWEEPS, high_ms=m.high * 1e3 / POSITION_SWEEPS,
        note="each sweep reads its answers back, so each synchronises")
    # The bitmap, rank and compaction launches of one positions sweep (one
    # launch batch a width group at i386: torch_backend.position_batches).
    check(all(len(torch_backend.position_batches(g.n, i386_dh.flat.numel(), g.t)) == 1
              for g in pos_bs.groups), "an i386 width group takes several positions launch batches")
    batches = [(i386_dh.flat, g.values_dev, g.masks_dev, g.ends_dev(hay_len), 0, g.n) for g in pos_bs.groups]
    bitmap = vs_plain(scan_kernel.match_bitmap_counted, scan_kernel.match_bitmap_counted_plain, batches,
                      f"match-bitmap kernel vs plain, one i386 positions sweep ({len(batches)} launch batches)",
                      rows=[b[5] for b in batches])
    # The rank kernel and the compaction, alone (device time, queued behind
    # a spin kernel) and as wrapper calls, packed as the sweep runs them and
    # capped at 4,096 (the JAX contract), beside the first design's torch
    # ops around its kernel and their bounds.
    pos_calls = sweep_times.positions_calls(pos_bs, i386_dh)
    pos_times = sweep_times.positions_kernel_times(torch, pos_calls, device)
    pos_bounds = sweep_times.positions_bounds(torch, pos_calls)
    say("times", what="rank and compaction kernels over one i386 positions sweep's bitmaps "
        "(ms per sweep: low, median, high; device_ms = the kernels alone behind a spin kernel, "
        "call_ms = wrapper calls between CUDA events)", card=card, calls=len(pos_calls),
        matches=sum(int(c[1].sum()) for c in pos_calls), kernels=pos_times, bounds=pos_bounds)
    ranks = (pos_times["item_ranks_packed"]["call_ms"][1], pos_times["item_ranks_plain"]["call_ms"][1])
    compact = (pos_times["compact_window_packed"]["call_ms"][1],
               pos_times["compact_window_plain_packed"]["call_ms"][1])

    # The find and count kernels per width group, next to the first
    # design's times; then, over the real words' tables in turns: the first
    # count loop (the harness's `word`), the count kernel, the harness's
    # `count` (the same loop: it must come within 5% of the kernel), its
    # `prefilter` and its `nomask`.
    groups = sweep_times.group_times(torch, bs, i386_dh, device)
    say("times", what="find and count kernels per width group, i386 (µs per launch: low, median, high)",
        card=card, rows={g.t: g.n for g in bs.groups},
        find_us={t: [round(x * 1e3, 1) for x in v] for t, v in groups["find"].items()},
        count_us={t: [round(x * 1e3, 1) for x in v] for t, v in groups["count"].items()},
        first_design_us=FIRST_DESIGN_GROUP_US)
    calls = group_calls(count_bs)
    runners = {"count kernel": scan_kernel.batched_count,
               **{f"harness {v}": (lambda *c, v=v: kp.probe(v, *c))
                  for v in ("word", "count", "prefilter", "nomask")}}
    order = ("harness word", "count kernel", "harness count", "harness prefilter", "harness nomask")
    turns = []
    for name in order + order[::-1]:
        fn = runners[name]
        m = measure(lambda: [fn(*c) for c in calls], name, warmup=1, samples=5, device=device)
        turns.append([name, m.estimate * 1e3])
    turn_ms = {name: sum(ms for n_, ms in turns if n_ == name) / 2 for name in order}
    say("times", what="count loops over one i386 sweep of the real words (all width groups), in turns: "
        "the first design (harness word), the count kernel, the harness's count (the same loop), "
        "its prefilter and its nomask", card=card, turns_ms=turns, ms=turn_ms,
        harness_count_over_kernel=turn_ms["harness count"] / turn_ms["count kernel"],
        prefilter_over_kernel=turn_ms["harness prefilter"] / turn_ms["count kernel"],
        nomask_over_kernel=turn_ms["harness nomask"] / turn_ms["count kernel"],
        first_design_over_kernel=turn_ms["harness word"] / turn_ms["count kernel"])
    check(abs(turn_ms["harness count"] / turn_ms["count kernel"] - 1) <= HARNESS_TOLERANCE,
          f"the harness's count variant ({turn_ms['harness count']:.4f} ms) is not within "
          f"{HARNESS_TOLERANCE:.0%} of the count kernel ({turn_ms['count kernel']:.4f} ms)")

    # The ablation table: K launches of each variant, one sync.
    table = {}
    for t, (flat, v, m_, e, n) in probe_setups.items():
        row = {}
        for variant in kp.VARIANTS:
            def launches(variant=variant):
                for _ in range(ABLATION_SWEEPS):
                    kp.probe(variant, flat, v, m_, e, n_real=n)

            k = measure(launches, f"probe {variant} t={t}", warmup=1, samples=3, device=device)
            per = k.estimate / ABLATION_SWEEPS
            row[variant] = {"ms_per_sweep": per * 1e3,
                            "ns_per_row_1024_positions": per * 1e9 / (n * hay_len / 1024)}
        table[t] = row
        say("probe_times", card=card, t=t, rows=n, sweeps=ABLATION_SWEEPS, variants=row)
    flat, v, m_, e, n = probe_setups[2]
    probe_plain = measure(lambda: kp.probe_plain("count", flat, v, m_, e, n_real=n),
                          "probe count plain t=2", warmup=1, samples=3, device=device)
    probe_ms = (table[2]["count"]["ms_per_sweep"], probe_plain.estimate * 1e3)
    say("times", what="probe kernel (count variant, t=2, 4,585 rows) vs plain", card=card,
        kernel_ms=probe_ms[0], plain_ms=probe_ms[1], speedup=probe_ms[1] / probe_ms[0])
    print("ablation, ms per sweep / ns per (row, 1024 positions), " + card)
    for t, row in table.items():
        print(f"  t={t}: " + "  ".join(f"{name} {r['ms_per_sweep']:.4f}/{r['ns_per_row_1024_positions']:.4f}"
                                      for name, r in row.items()))
    times = {"batched_find": find, "memchr_find": (mem_ms, mem_plain_ms),
             "batched_count": count, "pair_block": pair, "match_bitmap": bitmap,
             "item_ranks": ranks, "compact_window": compact, "probe": probe_ms}

    # Launches per sweep: one run of each kernel's sweep, counted.
    per_sweep = {}
    sweeps_of = {
        "batched_find": ("batched_find", lambda: bs.find_all_device(i386_dh)),
        "batched_count": ("batched_count", lambda: count_bs.count_all_device(i386_dh)),
        "match_bitmap": ("match_bitmap_counted", lambda: pos_bs.positions_all(i386_dh)),
        "item_ranks": ("item_ranks", lambda: pos_bs.positions_all(i386_dh)),
        "compact_window": ("compact_window", lambda: pos_bs.positions_all(i386_dh)),
        "memchr_find": ("memchr_find", lambda: scan_kernel.memchr_find(big_dh.flat, 255, big_end)),
        "pair_block": ("pair_block", ps.count_matches_device),
        "probe": ("probe", lambda: kp.probe("count", flat, v, m_, e, n_real=n)),
    }
    for name, (kernel, run) in sweeps_of.items():
        before = counter("launches." + kernel)
        run()
        per_sweep[name] = counter("launches." + kernel) - before
    torch.cuda.synchronize()
    bounds = sweep_bounds(torch, i386_dh, bs, pos_bs, big_end, ps, probe_setups[2], pos_bounds)
    say("bounds", card=card, means="least ms for the run's work: max(INT32 ops / 16.7 T op/s, "
        "bytes / 3.35 TB/s), one op per position tested", bounds=bounds, launches_per_sweep=per_sweep)
    return times, bounds, per_sweep, {k: v.get("device_ms", [None] * 3)[1] for k, v in pos_times.items()}


def sweep_bounds(torch, i386_dh, bs, pos_bs, big_end, ps, probe_setup, pos_bounds) -> dict:
    """{kernel: (bound ms, "operations" or "bytes")} for the work each
    timed kernel did in this run: one 32-bit operation per position these
    inputs need tested (find: up to each row's first match; count, bitmap
    and the ablation's count: every position below each row's limit; pair:
    up to each pair's first match or its last position; memchr: every byte
    scanned; the rank and compaction kernels: ``pos_bounds``, from
    ``sweep_times.positions_bounds``, packed as the sweep runs them), and
    every input read and output written once (the bitmap: the corpus once
    per launch batch, tables, ends, its words and item counts)."""
    from sliceslice_tpu_torch.ops import torch_backend
    from sliceslice_tpu_torch.ops.scan_kernel import BITMAP_CHUNK, bitmap_words
    from sliceslice_tpu_torch.ops.scan_math import position_limit
    from sliceslice_tpu_torch.utils.profiling import bound_ms

    length, numel = i386_dh.length, i386_dh.flat.numel()
    firsts = bs.find_all(i386_dh)

    def rows(searcher):
        for g in searcher.groups:
            g.sync_host()
            lim = np.minimum(np.maximum(length - g.lengths.astype(np.int64) + 1, 0),
                             position_limit(numel, g.t))
            yield g, lim

    find_ops = count_ops = scan_bytes = bitmap_bytes = 0
    for g, lim in rows(bs):
        f = firsts[g.indices]
        find_ops += int(np.where(f >= 0, np.minimum(f + 1, lim), lim).sum())
        count_ops += int(lim.sum())
        scan_bytes += numel + 4 * g.n_pad * (2 * g.t + 2)  # corpus, tables, ends, out
    for g, lim in rows(pos_bs):
        batches = len(torch_backend.position_batches(g.n, numel, g.t))
        n_chunks = -(-position_limit(numel, g.t) // BITMAP_CHUNK)
        bitmap_bytes += batches * numel + 4 * g.n * (2 * g.t + 1 + bitmap_words(numel, g.t) + n_chunks)
    first = ps.first_matrix()
    ln = np.array([len(w) for w in ps.needles], np.int64)
    tested = np.where(first >= 0, first + 1, np.maximum(ln[None, :] - ln[:, None] + 1, 0))
    pk, lh, _, _ = ps._pack_hay(None)
    pair_bytes = pk.numel() + 4 * lh.numel() + 4 * (ps._values.numel() + ps._masks.numel()) + 4 * len(ln) + 4
    flat, v, m, e, n = probe_setup
    probe_lim = e[:n].to(torch.int64).clamp(max=position_limit(flat.numel(), v.shape[1]))
    return {
        "batched_find": bound_ms(find_ops, scan_bytes),
        "batched_count": bound_ms(count_ops, scan_bytes),
        "match_bitmap": bound_ms(count_ops, bitmap_bytes),
        "item_ranks": pos_bounds["item_ranks_packed"],
        "compact_window": pos_bounds["compact_window_packed"],
        "memchr_find": bound_ms(big_end, big_end),
        "pair_block": bound_ms(int(tested.sum()), pair_bytes),
        "probe": bound_ms(int(probe_lim.sum()), flat.numel() + 4 * (v.numel() + m.numel() + 2 * n)),
    }


def main() -> int:
    import torch

    device = torch.device("cuda", 0)
    card = timed(phase_env, torch)
    timed(phase_build)
    errs = timed(phase_kernels, torch, device)

    hay = open(os.path.join(REPO, "data/i386.txt"), "rb").read()
    words = [w for w in open(os.path.join(REPO, "data/words.txt"), "rb").read().split(b"\n") if w]
    check(len(words) == 4585 and len(hay) == 857425, "unexpected corpus files")
    wrappers = {"batched_find": "batched_find", "memchr_find": "memchr_find",
                "batched_count": "batched_count", "pair_block": "pair_block",
                "match_bitmap": "match_bitmap_counted", "item_ranks": "item_ranks",
                "compact_window": "compact_window", "probe": "probe"}
    launches = {}

    def path(names, *phases, into=launches):
        """Drive one main path: its kernels' launches, counted from just
        before to just after."""
        before = {name: counter("launches." + wrappers[name]) for name in names}
        outs = [timed(fn, *args) for fn, args in phases]
        torch.cuda.synchronize()
        for name in names:
            into[name] = counter("launches." + wrappers[name]) - before[name]
            check(into[name] > 0, f"{name} was never launched by its main path")
        return outs

    (i386_dh, bs, i386_firsts), _, big = path(
        ("batched_find", "memchr_find"),
        (phase_i386, (torch, device, hay, words)),
        (phase_dynamic, (torch, device, hay)),
        (phase_big, (torch, device)))
    ((count_bs, i386_counts, big_counts),) = path(
        ("batched_count",), (phase_count, (torch, device, hay, words, i386_dh, big)))
    ((pos_bs, i386_positions, big_positions),) = path(("match_bitmap", "item_ranks", "compact_window"), (phase_positions, (
        torch, device, hay, words, i386_dh, big, i386_counts, big_counts)))
    ((ps, pair_exp),) = path(("pair_block",), (phase_pairwise, (torch, device, words)))
    ((errs["probe"], probe_setups),) = path(
        ("probe",), (phase_probe, (torch, device, hay, i386_dh, count_bs)))

    # The probe-table contract cases (their own counts).
    contracts_launches = {}
    path(("batched_find", "batched_count", "match_bitmap", "item_ranks", "compact_window"),
         (phase_contracts, (torch, device)), into=contracts_launches)

    timed(phase_queue_big, torch, device, big)
    timed(phase_group_wide, torch, device)
    # The huge-needle path (its own counts), then the CLI in processes of
    # its own.
    huge_launches = {}
    (i386_huge,) = path(("batched_count", "match_bitmap", "item_ranks", "compact_window"), (phase_huge, (
        torch, device, card, hay, words, i386_dh, (i386_firsts, i386_counts, i386_positions), big)),
        into=huge_launches)
    # Streams (their own counts): the 256 MiB corpus's 41 needles with
    # their first offsets from the positions phase's host oracle.
    stream_launches = {}
    big_firsts = np.array([p[0] if p.size else -1 for p in big_positions])
    big_answers = (big[2] + [BIG_PERIODIC], big_firsts, big_counts, big_positions)
    ((stream_per_window, stream_times, stream_windows),) = path(
        ("batched_find", "batched_count", "match_bitmap", "item_ranks", "compact_window"), (phase_stream, (
            torch, device, card, hay, words, (i386_firsts, i386_counts, i386_positions), big, big_answers,
            i386_huge)), into=stream_launches)
    per_stream_window = {"batched_find": stream_per_window["find"]["find"],
                         "batched_count": stream_per_window["count"]["count"],
                         "match_bitmap": stream_per_window["positions"]["bitmap"],
                         "item_ranks": stream_per_window["positions"]["ranks"],
                         "compact_window": stream_per_window["positions"]["compaction"]}
    timed(phase_stream_times, torch, device, card, big, big_answers[0], stream_times, stream_windows)
    # Sharded corpora (their own counts): the meshes of cells on the card in
    # an NCCL group of one, then two processes under gloo.
    sharded_launches = {}
    path(("batched_find", "batched_count", "match_bitmap", "item_ranks", "compact_window"), (phase_sharded, (
        torch, device, card, hay, words, i386_dh, (i386_firsts, i386_counts, i386_positions), big, big_answers,
        i386_huge)), into=sharded_launches)
    per_sharded_sweep = timed(phase_sharded_times, torch, device, card, words, i386_dh, big)
    timed(phase_cli, hay)
    # The harness and the bench (their own counts), the host oracles passed in.
    harness_launches = {}
    path(("batched_find", "memchr_find", "batched_count", "pair_block", "match_bitmap", "item_ranks",
          "compact_window"),
         (phase_harness, (torch, device, card, i386_firsts, pair_exp)), into=harness_launches)
    times, bounds, per_sweep, pos_device = timed(phase_times, torch, device, card, i386_dh, bs, big[0],
                                                 count_bs, ps, pos_bs, probe_setups)
    device_ms = {"item_ranks": pos_device["item_ranks_packed"],
                 "compact_window": pos_device["compact_window_packed"]}
    kernels = [
        ("batched_find", FIND_SOURCE, "sliceslice_tpu/ops/scan_kernel.py:266"),
        ("memchr_find", FIND_SOURCE, "sliceslice_tpu/ops/scan_kernel.py:720"),
        ("batched_count", FIND_SOURCE, "sliceslice_tpu/ops/scan_kernel.py:795"),
        ("pair_block", PAIR_SOURCE, "sliceslice_tpu/ops/pairwise.py:103"),
        ("probe", PROBE_SOURCE, "scripts/kernel_probe.py:64"),
        ("match_bitmap", FIND_SOURCE, "sliceslice_tpu/ops/xla_backend.py:140 (XLA, not Pallas)"),
        ("item_ranks", POSITIONS_SOURCE,
         "sliceslice_tpu/ops/xla_backend.py:195 (XLA, not Pallas: its counts and ranks)"),
        ("compact_window", POSITIONS_SOURCE, "sliceslice_tpu/ops/xla_backend.py:195 (XLA, not Pallas)"),
    ]
    # No single PyTorch call computes any of these functions (a first
    # match, an overlapping count, a match bitmap, a first byte, a pair
    # matrix of first matches, per-row counts and ranks of item counts, the
    # set bits of each bitmap row in a window of ranks), so library_ms is
    # null throughout.
    no_library = "no single PyTorch call computes this function"
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "device_ms": device_ms.get(name),
         "launches_per_sweep": per_sweep[name], "huge_path_launches": huge_launches.get(name),
         "stream_path_launches": stream_launches.get(name),
         "launches_per_stream_window": per_stream_window.get(name),
         "sharded_path_launches": sharded_launches.get(name),
         "launches_per_sharded_sweep_4x1": per_sharded_sweep.get(name),
         "harness_path_launches": harness_launches.get(name),
         "contracts_path_launches": contracts_launches.get(name),
         "library_ms": None, "library_note": no_library}
        for name, source, replaces in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if shutil.which("nvidia-smi") is None:
        print("chip_smoke: nvidia-smi not found; this needs an NVIDIA card", file=sys.stderr)
        sys.exit(1)
    sys.exit(main())
