#!/usr/bin/env python
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sliceslice_tpu_torch/csrc`` with
nvcc, holds each kernel against its plain PyTorch version on the card, and
drives the port's main paths against host oracles:

* find: ``preprocess`` -> ``BatchedSearcher.find_all`` over all 4,585
  words of data/words.txt in the 857,425-byte data/i386.txt, then
  ``DynamicSearcher``'s arms and a seeded 256 MiB corpus, against
  ``bytes.find``;
* count: ``BatchedSearcher.count_all`` over the same words and corpus
  before and after ``optimize_for``, ``DynamicSearcher.count_in`` on every
  arm and counts in the 256 MiB corpus, against ``overlapping_count``;
* positions: ``BatchedSearcher.positions_all`` over the same words and
  corpus before and after ``optimize_for`` (both tiers),
  ``DynamicSearcher.positions`` on every arm, a flat layout on the card
  kept without host bytes, and the 256 MiB corpus's needles, against the
  host positions oracle;
* the all-pairs sweep: ``PairwiseSearcher`` over the length-sorted words,
  all 21,022,225 pairs, against ``bytes.find``;
* the ablation harness: every variant of the probe kernel at t = 1, 2, 3
  over the JAX harness's tables (4,585 rows over i386), against its plain
  version and the count and find kernels;

then times the sweeps, each kernel and the ablation table with CUDA
events.  Every phase
prints one line and its seconds; any failure raises and exits non-zero.
The next-to-last lines are a JSON object describing the kernels and the
card's name and power limit; the last line is ``{"ok": true, "device":
...}``.  Imports nothing of JAX.
"""

from __future__ import annotations

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
BIG_BYTES = 256 * 1024 * 1024
SWEEPS = 32
#: positions_all sweeps per timed sample (each reads its answers back).
POSITION_SWEEPS = 4
#: Probe-table widths the ablation harness runs.
PROBE_TS = (1, 2, 3)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


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
    say("build", seconds=round(time.perf_counter() - t0, 3),
        nvcc_seconds=round(info.get("seconds", 0.0), 3),
        library=os.path.relpath(info["library"], REPO), ptxas=summary)


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


def _random_words(rng, count: int, max_len: int):
    """Seeded words of lengths 0..max_len over a 3-letter alphabet (so
    short words occur in long ones), plus the empty word."""
    return [bytes(rng.integers(97, 100, int(rng.integers(0, max_len + 1)), dtype=np.uint8))
            for _ in range(count)] + [b""]


def phase_kernels(torch, device):
    """Find, count, memchr and pair-block kernels against their plain
    versions (and the host oracles) on the card."""
    from sliceslice_tpu_torch import PairwiseSearcher, overlapping_count, preprocess
    from sliceslice_tpu_torch.config import SENTINEL
    from sliceslice_tpu_torch.needle import build_probe_table, needed_halo_for_t
    from sliceslice_tpu_torch.ops import pairwise, scan_kernel, torch_backend
    from sliceslice_tpu_torch.ops.scan_math import table_bits
    from sliceslice_tpu_torch.searcher import _host_positions

    rng = np.random.default_rng(1234)
    body = rng.integers(97, 101, (1 << 20) - 128, dtype=np.uint8)
    tail = rng.permutation(np.arange(128, 256, dtype=np.uint8))  # unique bytes
    hay = np.concatenate([body, tail]).tobytes()
    dh = preprocess(hay, kh=needed_halo_for_t(32), device=device)
    widths = list(range(1, 9)) + [16, 32]
    max_err = count_err = bitmap_err = 0
    rows = 0
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
            got = scan_kernel.match_bitmap(dh.flat, v, m, e, base=base, n_real=n_real)
            plain = scan_kernel.match_bitmap_plain(dh.flat, v, m, e, base=base, n_real=n_real)
            bitmap_err = max(bitmap_err, int((got.long() - plain.long()).abs().max()))
            check(torch.equal(got, plain), f"match-bitmap kernel != plain at t={t} base={base}")
            if base == 0:
                words = got.cpu().numpy()
                for i, nd in enumerate(needles):
                    check(np.array_equal(torch_backend.decode_match_bitmap(words[i]),
                                         _host_positions(hay, nd)),
                          f"match-bitmap kernel != host positions at t={t}, row {i}")
            rows += n_pad
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
        got, plain = pairwise.pair_block(*args), pairwise.pair_block_plain(*args)
        cnt, cnt_plain = pairwise.pair_block(*args, count=True), pairwise.pair_block_plain(*args, count=True)
        pair_err = max(pair_err, int((got - plain).abs().max()), abs(int(cnt) - int(cnt_plain)))
        check(torch.equal(got, plain) and int(cnt) == int(cnt_plain), f"pair kernel != plain, block {block}")
        hs = ws if hs is None else hs
        exp = np.array([[h.find(nd) for h in hs] for nd in ws], dtype=np.int32)
        check(np.array_equal(got.cpu().numpy(), exp), f"pair kernel != bytes.find, block {block}")
        check(int(cnt) == int((exp >= 0).sum()), f"pair kernel count != bytes.find, block {block}")
        pairs += exp.size
    say("kernels", find_rows=rows, find_widths=widths, find_max_abs_err=find_err,
        count_rows=rows, count_max_abs_err=count_err, bitmap_rows=rows,
        bitmap_max_abs_err=bitmap_err,
        memchr_cases=cases, memchr_max_abs_err=memchr_err,
        pair_pairs=pairs, pair_max_abs_err=pair_err, equal=True)
    return {"batched_find": find_err, "memchr_find": memchr_err,
            "batched_count": count_err, "pair_block": pair_err, "match_bitmap": bitmap_err}


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
    return dh, bs


def phase_dynamic(torch, device, hay):
    from sliceslice_tpu_torch import DynamicSearcher, preprocess
    from sliceslice_tpu_torch.ops import scan_kernel

    rng = np.random.default_rng(7)
    small = hay[100_000:106_000]          # bytes, 4096 < len <= 8192: flat rung
    tiny = preprocess(hay[:3000], device=device)   # DeviceHaystack, flat rung
    big = preprocess(hay, kh=64, device=device)    # kernel layout
    m0 = scan_kernel.memchr_find.launches
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
    memchr_runs = scan_kernel.memchr_find.launches - m0
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
    # phase's overlapping matches.
    arr[BIG_BYTES - 3000:BIG_BYTES - 1000] = np.tile(np.array([250, 251], np.uint8), 1000)
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


def phase_count(torch, device, hay, words, i386_dh, big):
    """Counts on the count path: all words over i386 before and after
    optimize_for, DynamicSearcher.count_in on every arm, and the 256 MiB
    corpus's planted needles and one periodic needle."""
    from sliceslice_tpu_torch import BatchedSearcher, DynamicSearcher, overlapping_count, preprocess
    from sliceslice_tpu_torch.ops import scan_kernel

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
    c0 = scan_kernel.batched_count.launches
    flat_bs = BatchedSearcher(flat_words, device=device)
    got = flat_bs.count_all(tiny)
    check(np.array_equal(got, [overlapping_count(hay[:3000], w) for w in flat_words]),
          "counts over the flat rung on the card differ")
    check(scan_kernel.batched_count.launches == c0 + len(flat_bs.groups),
          "count_all over the flat rung on the card did not launch the count kernel per group")
    lengths = [0, 1, 2, 3, 5, 8, 12, 16, 17, 24, 32, 33, 40, 100, 1000]
    checks = 0
    c0 = scan_kernel.batched_count.launches
    for k in lengths:
        for h_bytes, h in ((small, small), (hay[:3000], tiny), (hay, i386_dh), (hay, hay)):
            start = int(rng.integers(0, len(h_bytes) - k))
            for nd in (h_bytes[start:start + k], h_bytes[-k:] if k else b"", b"\xfe" * k):
                before = scan_kernel.batched_count.launches
                got = DynamicSearcher(nd, device=device).count_in(h)
                check(got == overlapping_count(h_bytes, nd), f"DynamicSearcher.count_in k={k} differs")
                if k and h is tiny:
                    check(scan_kernel.batched_count.launches == before + 1,
                          f"count_in k={k} over the flat rung on the card did not launch the count kernel")
                checks += 1
        if k == 1:
            check(scan_kernel.batched_count.launches > c0, "the 1-byte arm never launched the count kernel")

    big_dh, big_hay, big_needles = big
    periodic = b"\xfa\xfb" * 3
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
    return bs, int(exp.sum()), exp_big


def phase_positions(torch, device, hay, words, i386_dh, big, i386_total, big_counts):
    """Positions on the positions path: all words over i386 before and
    after optimize_for (both tiers), DynamicSearcher.positions on every
    arm, a flat layout on the card kept without host bytes, and the 256 MiB
    corpus's needles and periodic run; totals against the count phase."""
    from sliceslice_tpu_torch import BatchedSearcher, DynamicSearcher, preprocess
    from sliceslice_tpu_torch.ops import scan_kernel, torch_backend
    from sliceslice_tpu_torch.searcher import _host_positions

    cap = torch_backend.SPARSE_POSITIONS_CAP
    t0 = time.perf_counter()
    exp = [_host_positions(hay, w) for w in words]
    oracle_s = time.perf_counter() - t0
    bs = BatchedSearcher(words, device=device)

    def same(got, exp_rows, what):
        bad = sum(not np.array_equal(g, e) for g, e in zip(got, exp_rows))
        check(len(got) == len(exp_rows) and bad == 0, f"{what}: {bad} rows differ")

    got = bs.positions_all(i386_dh)
    same(got, exp, "i386 positions")
    total = sum(len(p) for p in got)
    dense = sum(len(p) > cap for p in got)
    check(total == i386_total, f"i386 positions total {total} != count total {i386_total}")
    check(0 < dense < len(words), f"i386 positions: {dense} dense rows, no row on one tier")
    bs.optimize_for(i386_dh)
    same(bs.positions_all(i386_dh), exp, "i386 positions after optimize_for")

    rng = np.random.default_rng(13)
    small = hay[100_000:106_000]            # bytes, 4096 < len <= 8192: host positions
    tiny = preprocess(hay[:3000], keep_host=False, device=device)   # flat rung, card only
    check(not tiny.tiled, "the 3,000-byte layout is not the flat rung")
    flat_words = words[::15]
    b0 = scan_kernel.match_bitmap.launches
    flat_bs = BatchedSearcher(flat_words, device=device)
    same(flat_bs.positions_all(tiny), [_host_positions(hay[:3000], w) for w in flat_words],
         "positions over the flat rung on the card")
    check(scan_kernel.match_bitmap.launches > b0,
          "positions_all over the flat rung on the card did not launch the bitmap kernel")
    lengths = [0, 1, 2, 3, 5, 8, 12, 16, 17, 24, 32, 33, 40, 100, 1000]
    checks = 0
    for k in lengths:
        for h_bytes, h in ((small, small), (hay[:3000], tiny), (hay, i386_dh), (hay, hay)):
            start = int(rng.integers(0, len(h_bytes) - k))
            for nd in (h_bytes[start:start + k], h_bytes[-k:] if k else b"", b"\xfe" * k,
                       h_bytes[len(h_bytes) - k + 1:] + b"\0" if k else b""):
                before = scan_kernel.match_bitmap.launches
                got = DynamicSearcher(nd, device=device).positions(h)
                check(np.array_equal(got, _host_positions(h_bytes, nd)),
                      f"DynamicSearcher.positions k={k} differs")
                if k and h is tiny:
                    check(scan_kernel.match_bitmap.launches == before + 1,
                          f"positions k={k} over the flat rung on the card did not launch the bitmap kernel")
                checks += 1

    big_dh, big_hay, big_needles = big
    periodic = b"\xfa\xfb" * 3
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
        sparse_cap=cap, parity=True, parity_after_optimize_for=True,
        flat_rung_words=len(flat_words), dynamic_lengths=lengths, dynamic_checks=checks,
        big_needles=len(needles), big_total_matches=int(sizes.sum()),
        big_dense_rows=int((sizes > cap).sum()), host_oracle_s=round(oracle_s, 3))
    return bs


def phase_probe(torch, device, hay):
    """Every variant of the ablation kernel at t = 1, 2, 3 over the JAX
    harness's tables (4,585 rows over i386): equal to its plain version,
    the answer-preserving ones to the count and find kernels, the planted
    rows (t=2) at their bytes.find offsets."""
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
    say("probe", rows=n, widths=list(PROBE_TS), variants=list(kp.VARIANTS), max_abs_err=err,
        equal_to_plain=True, counting_equal_batched_count=True, first_equal_batched_find=True,
        planted_rows_first_count=plants)
    return err, setups


def phase_pairwise(torch, device, words):
    """All 21,022,225 pairs of the length-sorted words, as bench.py sorts
    them, against bytes.find."""
    from sliceslice_tpu_torch import PairwiseSearcher

    ws = sorted(words, key=len)
    t0 = time.perf_counter()
    exp = np.empty((len(ws), len(ws)), np.int32)
    for i, nd in enumerate(ws):
        exp[i] = [h.find(nd) for h in ws]
    oracle_s = time.perf_counter() - t0
    ps = PairwiseSearcher(ws, device=device)
    first = ps.first_matrix()
    check(np.array_equal(first, exp), f"pair sweep: {int((first != exp).sum())} pairs' first differ")
    contains = ps.contains_matrix()
    check(np.array_equal(contains, exp >= 0), "pair sweep: contains differs")
    total = int(ps.count_matches_device())
    check(total == int(contains.sum()), "pair sweep: count_matches_device != contains.sum()")
    plan = ps._plan(None)
    say("pairwise", words=len(ws), pairs=exp.size, matches=total,
        plan_blocks=len(plan), skipped_blocks=sum(1 for e in plan if e[2] == 0),
        host_oracle_s=round(oracle_s, 3), parity=True)
    return ps


def phase_times(torch, device, card, i386_dh, bs, big_dh, count_bs, ps, pos_bs, probe_setups):
    from sliceslice_tpu_torch.ops import pairwise, scan_kernel
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
    pk, lh, _, _ = ps._pack_hay(None)
    args = (ps._values, ps._masks, ps._ln, pk, lh, ps._plan(None), ps.block)
    matrix = measure(lambda: pairwise.pair_block(*args), "pair kernel, matrix mode", warmup=1,
                     samples=5, device=device)
    pair = vs_plain(lambda *a: pairwise.pair_block(*a, count=True),
                    lambda *a: pairwise.pair_block_plain(*a, count=True), [args],
                    "pair kernel vs plain, count mode, one all-pairs sweep",
                    matrix_mode_kernel_ms=matrix.estimate * 1e3)

    def pos_sweeps():
        for _ in range(POSITION_SWEEPS):
            pos_bs.positions_all(i386_dh)

    m = measure(pos_sweeps, f"i386 positions sweep x{POSITION_SWEEPS}", warmup=1, samples=3,
                device=device)
    say("times", what="sustained i386 positions sweep (positions_all, batch 16, after optimize_for)",
        card=card, sweeps=POSITION_SWEEPS, ms_per_sweep=m.estimate * 1e3 / POSITION_SWEEPS,
        low_ms=m.low * 1e3 / POSITION_SWEEPS, high_ms=m.high * 1e3 / POSITION_SWEEPS,
        note="each sweep reads its answers back, so each synchronises")
    batches = [(i386_dh.flat, g.values_dev[i0:i0 + 16], g.masks_dev[i0:i0 + 16],
                g.ends_dev(hay_len)[i0:i0 + 16], 0, min(16, g.n - i0))
               for g in pos_bs.groups for i0 in range(0, g.n, 16)]
    bitmap = vs_plain(scan_kernel.match_bitmap, scan_kernel.match_bitmap_plain, batches,
                      f"match-bitmap kernel vs plain, one i386 positions sweep ({len(batches)} batches of <= 16 rows)")

    # The ablation table: K launches of each variant, one sync.
    table = {}
    for t, (flat, v, m_, e, n) in probe_setups.items():
        row = {}
        for variant in kp.VARIANTS:
            def launches(variant=variant):
                for _ in range(SWEEPS):
                    kp.probe(variant, flat, v, m_, e, n_real=n)

            k = measure(launches, f"probe {variant} t={t}", warmup=1, samples=3, device=device)
            per = k.estimate / SWEEPS
            row[variant] = {"ms_per_sweep": per * 1e3,
                            "ns_per_row_1024_positions": per * 1e9 / (n * hay_len / 1024)}
        table[t] = row
        say("probe_times", card=card, t=t, rows=n, sweeps=SWEEPS, variants=row)
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
    return {"batched_find": find, "memchr_find": (mem_ms, mem_plain_ms),
            "batched_count": count, "pair_block": pair, "match_bitmap": bitmap, "probe": probe_ms}


def main() -> int:
    import torch

    device = torch.device("cuda", 0)
    card = timed(phase_env, torch)
    timed(phase_build)
    errs = timed(phase_kernels, torch, device)

    from sliceslice_tpu_torch.ops import pairwise, scan_kernel
    from sliceslice_tpu_torch.scripts import kernel_probe

    hay = open(os.path.join(REPO, "data/i386.txt"), "rb").read()
    words = [w for w in open(os.path.join(REPO, "data/words.txt"), "rb").read().split(b"\n") if w]
    check(len(words) == 4585 and len(hay) == 857425, "unexpected corpus files")
    wrappers = {"batched_find": scan_kernel.batched_find, "memchr_find": scan_kernel.memchr_find,
                "batched_count": scan_kernel.batched_count, "pair_block": pairwise.pair_block,
                "match_bitmap": scan_kernel.match_bitmap, "probe": kernel_probe.probe}
    launches = {}

    def path(names, *phases):
        """Drive one main path: its kernels' counts start at 0 just before
        and are read just after."""
        for name in names:
            wrappers[name].launches = 0
        outs = [timed(fn, *args) for fn, args in phases]
        torch.cuda.synchronize()
        for name in names:
            launches[name] = wrappers[name].launches
            check(launches[name] > 0, f"{name} was never launched by its main path")
        return outs

    (i386_dh, bs), _, big = path(
        ("batched_find", "memchr_find"),
        (phase_i386, (torch, device, hay, words)),
        (phase_dynamic, (torch, device, hay)),
        (phase_big, (torch, device)))
    ((count_bs, i386_total, big_counts),) = path(
        ("batched_count",), (phase_count, (torch, device, hay, words, i386_dh, big)))
    (pos_bs,) = path(("match_bitmap",), (phase_positions, (
        torch, device, hay, words, i386_dh, big, i386_total, big_counts)))
    (ps,) = path(("pair_block",), (phase_pairwise, (torch, device, words)))
    ((errs["probe"], probe_setups),) = path(("probe",), (phase_probe, (torch, device, hay)))

    times = timed(phase_times, torch, device, card, i386_dh, bs, big[0], count_bs, ps, pos_bs,
                  probe_setups)
    kernels = [
        ("batched_find", FIND_SOURCE, "sliceslice_tpu/ops/scan_kernel.py:266"),
        ("memchr_find", FIND_SOURCE, "sliceslice_tpu/ops/scan_kernel.py:720"),
        ("batched_count", FIND_SOURCE, "sliceslice_tpu/ops/scan_kernel.py:795"),
        ("pair_block", PAIR_SOURCE, "sliceslice_tpu/ops/pairwise.py:103"),
        ("probe", PROBE_SOURCE, "scripts/kernel_probe.py:64"),
        ("match_bitmap", FIND_SOURCE, "sliceslice_tpu/ops/xla_backend.py:140 (XLA, not Pallas)"),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1]} for name, source, replaces in kernels]}))
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
