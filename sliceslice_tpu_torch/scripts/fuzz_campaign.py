"""Randomized differential fuzz of the port's kernels through its public
API, against ``bytes.find``, a regex count and the host positions scan.

    python -m sliceslice_tpu_torch.scripts.fuzz_campaign [rounds=10] [seed=20260818] [--device cpu|cuda]

The port of ``scripts/fuzz_campaign.py``: fixed layout sizes, with the
randomness in content, needle placement and API choice.  Per layout and
round, needles of every dispatch rung (:data:`KS`, k = 1..64) in six
modes: present at a random offset, one byte flipped (absent), at the last
valid position, across the first boundary of the find kernel's work queue
(:func:`queue_boundary`), random binary bytes (NUL included) and periodic;
``BatchedSearcher`` find, count and positions, and ``DynamicSearcher``
(its 1-byte arm is the memchr kernel) over the same layout.  Then
streams (needles across window boundaries, offsets past 2^33 through
``start_offset``, huge needles), the all-pairs matrix of random word lists
and ``ShardedBatchedSearcher`` over meshes of 4x1 and 2x2 cells on the one
device (needles across the shard boundary, the int64 combine, huge
needles).  Prints the card's name and power limit first, every mismatch as
a line holding ``MISMATCH``, and last the trials and failures per part;
exits 1 on any failure.  Imports no jax.
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import Callable, Union

import numpy as np

KS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16, 17, 24, 33, 64]

#: (corpus bytes, preprocess arguments): the JAX campaign's sizes.  The
#: first two are its flat rung and its forced tiled layout, which the port
#: lays out alike; the last two hold more than one chunk of the find
#: kernel's work queue.
LAYOUTS = [
    (4096, {}),
    (4096, {"force_cols": True}),
    (50_000, {"kh": 64}),
    (300_000, {"kh": 64}),
]
#: The sharded part's meshes of cells on the one device.
MESHES = [(4, 1), (2, 2)]


def queue_boundary(dh, k: int) -> int:
    """Byte offset of the first boundary between work items of the find
    kernel's queue over ``dh`` for a needle of ``k`` bytes (one row: the
    chunk doubles only past 2^31 items).  It lies past the corpus's end
    when the layout is shorter than one chunk."""
    from sliceslice_tpu_torch.needle import num_probes
    from sliceslice_tpu_torch.ops.scan_kernel import FIND_CHUNK, plan_queue

    return plan_queue(dh.flat.numel(), num_probes(k), 1, 1, FIND_CHUNK).chunk


def gen_needles(hay: bytes, n_per: int, rng, boundary: Union[int, Callable[[int], int]]) -> list:
    """``n_per`` needles of each length in :data:`KS` (those that fit),
    each in a random one of six modes; mode 3 straddles ``boundary`` (a
    byte offset, or a function of the needle's length giving one), or
    takes mode 0 when the boundary lies at or past the corpus's end.  The
    JAX campaign's needles, byte for byte, for the same rng and boundary."""
    L = len(hay)
    needles = []
    for k in KS:
        if k > L:
            continue
        b = boundary(k) if callable(boundary) else boundary
        for _ in range(n_per):
            mode = rng.integers(0, 6)
            if mode == 3 and b >= L:
                mode = 0  # no boundary to straddle
            if mode == 0:
                o = int(rng.integers(0, L - k + 1))
                w = hay[o:o + k]
            elif mode == 1:
                o = int(rng.integers(0, L - k + 1))
                w = bytearray(hay[o:o + k])
                w[int(rng.integers(0, k))] ^= 0xFF
                w = bytes(w)
            elif mode == 2:
                w = hay[L - k:]
            elif mode == 3:
                o = max(0, min(L - k, b - k // 2))
                w = hay[o:o + k]
            elif mode == 4:
                w = bytes(rng.integers(0, 256, k, dtype=np.uint8).tolist())
            else:
                w = (hay[3:3 + max(1, k // 2)] * 4)[:k]
            needles.append(w)
    return needles


def regex_count(hay: bytes, w: bytes) -> int:
    return len(re.findall(b"(?=" + re.escape(w) + b")", hay))


def fuzz_layouts(rounds: int, rng, device) -> tuple:
    """Find, count and positions of :func:`gen_needles` over each layout
    of :data:`LAYOUTS`, ``rounds`` corpora each (lowercase and binary in
    turns), and ``DynamicSearcher`` over the same layout."""
    from sliceslice_tpu_torch import BatchedSearcher, DynamicSearcher, preprocess
    from sliceslice_tpu_torch.searcher import _host_positions

    fails = trials = 0
    for L, kw in LAYOUTS:
        for rnd in range(rounds):
            hay = (rng.integers(0, 256, L, dtype=np.uint8).tobytes() if rnd % 2
                   else rng.integers(97, 103, L, dtype=np.uint8).tobytes())
            dh = preprocess(hay, device=device, **kw)
            needles = gen_needles(hay, 4, rng, lambda k: queue_boundary(dh, k))
            got = BatchedSearcher(needles, device=device).find_all(dh)
            exp = np.array([hay.find(w) for w in needles])
            bad = got != exp
            trials += len(needles)
            if bad.any():
                fails += int(bad.sum())
                i = int(np.argmax(bad))
                print("FIND MISMATCH", L, kw, needles[i], got[i], exp[i], flush=True)
            dyn = [i for i, w in enumerate(needles) if len(w) == 1 or i % 5 == 0]
            for i in dyn:
                f = DynamicSearcher(needles[i], device=device).find(dh)
                if (-1 if f is None else f) != exp[i]:
                    fails += 1
                    print("DYNAMIC MISMATCH", L, kw, needles[i], f, exp[i], flush=True)
            trials += len(dyn)
            sub = needles[::7]
            bs = BatchedSearcher(sub, device=device)
            cnt = bs.count_all(dh)
            cexp = np.array([regex_count(hay, w) for w in sub])
            trials += len(sub)
            if (cnt != cexp).any():
                fails += int((cnt != cexp).sum())
                print("COUNT MISMATCH", L, kw, flush=True)
            pos = bs.positions_all(dh)
            trials += len(sub)
            for w, p in zip(sub, pos):
                if not np.array_equal(p, _host_positions(hay, w)):
                    fails += 1
                    print("POSITIONS MISMATCH", L, kw, w, flush=True)
    return trials, fails


def fuzz_streaming(rounds: int, rng, device) -> tuple:
    """Random corpora, windows and chunkings through ``StreamingScanner``:
    needles across the first and a later window boundary, absent and
    binary ones, half the time a huge needle (across a window boundary
    half of those) and an absent one; find (early stop at random), count
    and positions, at a random ``start_offset`` below 2^33."""
    from sliceslice_tpu_torch import StreamingScanner
    from sliceslice_tpu_torch.needle import MAX_NEEDLE_LEN
    from sliceslice_tpu_torch.searcher import _host_positions

    fails = trials = 0
    for _ in range(rounds):
        L = int(rng.integers(30_000, 200_000))
        hay = rng.integers(97, 103, L, dtype=np.uint8).tobytes()
        window = int(rng.integers(8_192, 40_000))
        needles = []
        for k in (3, 5, 8, 13, 21):
            for b in (window, window * 2 + 7):
                o = max(0, min(L - k, b - k // 2))
                needles.append(hay[o:o + k])
            o = int(rng.integers(0, L - k + 1))
            needles.append(hay[o:o + k])
            needles.append(bytes([0xFF]) + hay[o:o + k - 1])
        needles.append(hay[L - 9:])
        if rng.integers(0, 2):
            kh_ = MAX_NEEDLE_LEN + int(rng.integers(1, 400))
            if L > kh_ + 10:
                o = (max(0, window - kh_ // 2) if rng.integers(0, 2)
                     else int(rng.integers(0, L - kh_)))
                needles.append(hay[o:o + kh_])
                needles.append(bytes(kh_))
        ss = StreamingScanner(needles, window_bytes=window, device=device)
        cuts = np.sort(rng.integers(1, L, int(rng.integers(3, 40))))
        chunks = [hay[a:b] for a, b in zip([0, *cuts.tolist()], [*cuts.tolist(), L])]
        base = int(rng.integers(0, 2)) * int(rng.integers(0, 2**33))
        got = ss.find_in_chunks(chunks, early_stop=bool(rng.integers(0, 2)), start_offset=base)
        exp = np.array([hay.find(w) for w in needles])
        expb = np.where(exp < 0, -1, exp + base)
        bad = got != expb
        trials += len(needles)
        if bad.any():
            fails += int(bad.sum())
            i = int(np.argmax(bad))
            print("STREAM MISMATCH", L, window, needles[i][:32], got[i], expb[i], flush=True)
        sub = needles[::max(1, len(needles) // 6)]
        ss2 = StreamingScanner(sub, window_bytes=window, device=device)
        cnt = ss2.count_in_chunks(iter(chunks))
        trials += len(sub)
        if list(cnt) != [regex_count(hay, w) for w in sub]:
            fails += 1
            print("STREAM COUNT MISMATCH", L, window, flush=True)
        pos = ss2.positions_in_chunks(iter(chunks), start_offset=base)
        trials += len(sub)
        for w, p in zip(sub, pos):
            if not np.array_equal(p, _host_positions(hay, w) + base):
                fails += 1
                print("STREAM POSITIONS MISMATCH", L, window, w[:16], flush=True)
    return trials, fails


def fuzz_pairwise(rounds: int, rng, device) -> tuple:
    """Random word lists (binary bytes, shared prefixes, duplicates,
    1-byte words) through ``PairwiseSearcher.first_matrix``."""
    from sliceslice_tpu_torch import PairwiseSearcher

    fails = trials = 0
    for _ in range(rounds):
        n = int(rng.integers(20, 120))
        words = []
        for _ in range(n):
            k = int(rng.integers(1, 28))
            if rng.integers(0, 4) == 0 and words:
                base = words[int(rng.integers(0, len(words)))]
                w = (base + bytes(rng.integers(0, 256, k).tolist()))[:k]
            else:
                lo, hi = (97, 105) if rng.integers(0, 2) else (0, 256)
                w = bytes(rng.integers(lo, hi, k, dtype=np.uint8).tolist())
            words.append(w)
        words.sort(key=len)
        got = PairwiseSearcher(words, device=device).first_matrix(words)
        exp = np.array([[h.find(nd) for h in words] for nd in words])
        bad = got != exp
        trials += got.size
        if bad.any():
            fails += int(bad.sum())
            i, j = np.argwhere(bad)[0]
            print("PAIR MISMATCH", words[i], words[j], got[i, j], exp[i, j], flush=True)
    return trials, fails


def fuzz_sharded(rounds: int, rng, device) -> tuple:
    """Random corpora through ``ShardedBatchedSearcher`` on meshes of
    :data:`MESHES` cells: find (with the int64 combine forced at random),
    count, positions (gathered or not at random), needles across the first
    shard boundary of the 4x1 mesh, and half the time a huge needle, an
    absent huge one and a short one."""
    from sliceslice_tpu_torch import preprocess
    from sliceslice_tpu_torch.needle import MAX_NEEDLE_LEN
    from sliceslice_tpu_torch.parallel import ShardedBatchedSearcher, make_mesh
    from sliceslice_tpu_torch.parallel.shard_scan import shard_bytes_for
    from sliceslice_tpu_torch.searcher import _host_positions

    fails = trials = 0
    for rnd in range(rounds):
        L = int(rng.integers(60_000, 250_000))
        lo, hi = (97, 103) if rnd % 2 else (0, 256)
        hay = rng.integers(lo, hi, L, dtype=np.uint8).tobytes()
        dh = preprocess(hay, kh=32, device=device)
        needles = gen_needles(hay, 1, rng, shard_bytes_for(L, MESHES[0][0]))[:24]
        exp_find = np.array([hay.find(w) for w in needles])
        for shape in MESHES:
            mesh = make_mesh(shape, device=device)
            sb = ShardedBatchedSearcher(needles, mesh)
            sb.force_int64 = bool(rng.integers(0, 2))
            got = sb.find_all(dh)
            bad = got != exp_find
            trials += len(needles)
            if bad.any():
                fails += int(bad.sum())
                i = int(np.argmax(bad))
                print("SHARD FIND MISMATCH", shape, needles[i], got[i], exp_find[i], flush=True)
            sub = needles[::5]
            sbc = ShardedBatchedSearcher(sub, mesh)
            cnt = sbc.count_all(dh)
            cexp = np.array([regex_count(hay, w) for w in sub])
            trials += len(sub)
            if (cnt != cexp).any():
                fails += int((cnt != cexp).sum())
                print("SHARD COUNT MISMATCH", shape, flush=True)
            pos = sbc.positions_all(dh, gather=bool(rng.integers(0, 2)))
            trials += len(sub)
            for w, p in zip(sub, pos):
                if not np.array_equal(p, _host_positions(hay, w)):
                    fails += 1
                    print("SHARD POSITIONS MISMATCH", shape, w, flush=True)
            if rng.integers(0, 2):
                kh_ = MAX_NEEDLE_LEN + int(rng.integers(1, 300))
                if L > kh_ + 10:
                    o = int(rng.integers(0, L - kh_))
                    hsub = [hay[o:o + kh_], bytes(kh_), needles[0]]
                    hf = ShardedBatchedSearcher(hsub, mesh).find_all(dh)
                    hexp = np.array([hay.find(w) for w in hsub])
                    trials += len(hsub)
                    if (hf != hexp).any():
                        fails += int((hf != hexp).sum())
                        print("SHARD HUGE MISMATCH", shape, o, kh_, flush=True)
    return trials, fails


def campaign(rounds: int = 10, seed: int = 20260818, device="cuda") -> dict:
    """{part: (trials, failures)} of one campaign: the layouts (``rounds``
    each), then streams and pairs (``max(2, rounds // 2)``) and the
    sharded part (``max(2, rounds // 3)``), from one rng."""
    rng = np.random.default_rng(seed)
    return {
        "layouts": fuzz_layouts(rounds, rng, device),
        "streaming": fuzz_streaming(max(2, rounds // 2), rng, device),
        "pairwise": fuzz_pairwise(max(2, rounds // 2), rng, device),
        "sharded": fuzz_sharded(max(2, rounds // 3), rng, device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rounds", nargs="?", type=int, default=10)
    ap.add_argument("seed", nargs="?", type=int, default=20260818)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from sliceslice_tpu_torch.ops.layout import resolve_device
    from sliceslice_tpu_torch.utils.profiling import device_line

    device = resolve_device(args.device)
    print(device_line(device), flush=True)
    parts = campaign(args.rounds, args.seed, device)
    trials = sum(t for t, _ in parts.values())
    fails = sum(f for _, f in parts.values())
    each = ", ".join(f"{name} {t} trials {f} failures" for name, (t, f) in parts.items())
    print(f"fuzz campaign: {trials} trials, {fails} failures ({each}; seed {args.seed}, "
          f"{args.rounds} rounds over {len(LAYOUTS)} layouts)", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
