"""Pairwise containment sweep — the short-haystack workload.

Counterpart of ``sliceslice_tpu/ops/pairwise.py``.  The reference's
short-haystack bench and conformance sweep search every dictionary word in
every word, one ``search_in`` call per pair (bench/benches/i386.rs:16-155,
tests/i386.rs:46-59).  Here needle n is ``T = ceil(k/4)`` masked uint32
window compares, as in the long-haystack kernels, and for candidate
position i, probe slot t compares

    (win32(h, i + 4t) & mask[n, t]) == value[n, t]

ANDed over slots (a mask-0 slot is trivially true, so mixed lengths need no
extra masking), valid for ``i <= len(h) - len(n)``; a pair reports its
smallest valid matching i.

The pair matrix is cut into ``block x block`` blocks and a static plan
buckets each block's probe width and scan length and skips blocks whose
shortest needle is longer than their longest word (all-false).
:func:`pair_block` evaluates every non-skipped block of the plan in one
launch of the hand-written CUDA kernel ``csrc/pairwise.cu`` (replacing the
Pallas ``_pair_block_call``, one call per block); its plain PyTorch
version :func:`pair_block_plain` runs for tensors on the CPU.  The checked
plan and its device table make a :class:`PairLaunch`, which
:class:`PairwiseSearcher` caches per haystack list: a repeated sweep zeroes
one counter pair and launches once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..needle import build_probe_table
from ..searcher import DeviceLike, resolve_device
from ..utils import tracing
from . import cuda_lib
from .scan_math import packed_windows, table_bits

#: Block edge of the pair matrix plan (a block is BLOCK x BLOCK pairs), as
#: in the JAX package, so both packages plan the same blocks.
BLOCK = 512


def pack_words(words: Sequence[bytes], width: int):
    """Pad words into (W, width) uint8 plus lengths (W,) int32."""
    arr = np.zeros((len(words), width), dtype=np.uint8)
    lens = np.zeros((len(words),), dtype=np.int32)
    for i, w in enumerate(words):
        if len(w) > width:
            raise ValueError(f"word {i} longer than width={width}")
        arr[i, : len(w)] = np.frombuffer(w, dtype=np.uint8)
        lens[i] = len(w)
    return arr, lens


def max_len(words: Sequence[bytes]) -> int:
    return max((len(w) for w in words), default=1) or 1


def _check_int32(name: str, x: torch.Tensor, dim: int) -> None:
    if x.dtype != torch.int32 or x.dim() != dim:
        raise ValueError(f"{name} must be a {dim}-D int32 tensor")


def _plan_array(plan, n_rows: int, n_cols: int, tn: int, hw: int) -> np.ndarray:
    """The plan's non-skipped entries as int32 (E, 4), checked against the
    operands: every block inside the matrix, every probe width within the
    table and every scanned window within the packed words."""
    arr = np.asarray(plan, dtype=np.int64).reshape(-1, 4)
    arr = arr[arr[:, 2] > 0]
    i0, j0, tn_b, mi_b = arr.T
    words = ((mi_b - 1) >> 2) + tn_b + 1
    if ((i0 < 0) | (i0 >= n_rows) | (j0 < 0) | (j0 >= n_cols) | (tn_b > tn)
            | (mi_b < 1) | (words > hw)).any():
        raise ValueError("pair plan entry outside the tables or the packed words")
    return np.ascontiguousarray(arr, dtype=np.int32)


def _pair_tile(values, masks, ln, wins, lh, tn: int, mi: int) -> torch.Tensor:
    """One block of pairs as plain torch ops, the counterpart of the JAX
    ``_pair_block``: values/masks (nb, >= tn), ln (nb,), wins (hb, >= mi +
    4*tn - 4) windows of each word, lh (hb,) -> first (nb, hb) int32 in
    [0, mi], mi = no match."""
    limit = lh[None, :] - ln[:, None]  # valid i <= len(h) - len(n)
    first = torch.full((ln.shape[0], lh.shape[0]), mi, dtype=torch.int32, device=wins.device)
    v, m = values[:, None, :tn], masks[:, None, :tn]
    slots = 4 * torch.arange(tn, device=wins.device)
    # i runs DESCENDING, so a plain select keeps the smallest matching i;
    # validity is a prefix of the range, so the smallest raw match is valid
    # iff it is <= limit.
    for i in range(mi - 1, -1, -1):
        hit = ((wins[None, :, i + slots] & m) == v).all(dim=2)
        first = torch.where(hit, i, first)
    return torch.where(first <= limit, first, mi).to(torch.int32)


def _pair_blocks_plain(values, masks, ln, hay, lh, entries, block: int, count: bool):
    """The checked plan entries ``(i0, j0, tn_b, mi_b)`` (non-skipped) as
    plain torch ops."""
    n, h = ln.shape[0], lh.shape[0]
    wins = packed_windows(hay)
    device = hay.device
    total = torch.zeros((), dtype=torch.int32, device=device)
    first = None if count else torch.full((n, h), -1, dtype=torch.int32, device=device)
    for i0, j0, tn_b, mi_b in entries:
        f = _pair_tile(
            values[i0 : i0 + block], masks[i0 : i0 + block], ln[i0 : i0 + block],
            wins[j0 : j0 + block], lh[j0 : j0 + block], tn_b, mi_b,
        )
        hit = f < mi_b
        if count:
            total += hit.sum(dtype=torch.int32)
        else:
            first[i0 : i0 + f.shape[0], j0 : j0 + f.shape[1]] = torch.where(hit, f, -1)
    return total if count else first


def pair_block_plain(values, masks, ln, hay, lh, plan, block: int, count: bool = False):
    """Plain PyTorch version of :func:`pair_block` (same signature and
    answers)."""
    entries = _plan_array(plan, ln.shape[0], lh.shape[0], values.shape[1], hay.shape[1] // 4)
    return _pair_blocks_plain(values, masks, ln, hay, lh, entries.tolist(), block, count)


class PairLaunch(NamedTuple):
    """One sweep's launch plan, checked once and kept on the operands'
    device, so that a repeated sweep is one zeroed counter and one launch.

    ``operands``: contiguous ``(values, masks, ln, hay, lh)``; ``live``: the
    plan's non-skipped entries, checked, on the host (int32 (E, 4));
    ``table``: their copy on the device, which the kernel walks."""

    operands: tuple
    block: int
    live: np.ndarray
    table: torch.Tensor


def plan_launch(values, masks, ln, hay, lh, plan, block: int) -> PairLaunch:
    """Check :func:`pair_block`'s operands and plan and put the plan's table
    on their device.  The counter ``uploads.pair_block``
    (:mod:`..utils.tracing`) counts the tables sent to a card."""
    device = hay.device
    for name, x, dim in (("values", values, 2), ("masks", masks, 2), ("ln", ln, 1), ("lh", lh, 1)):
        _check_int32(name, x, dim)
    if hay.dtype != torch.uint8 or hay.dim() != 2 or hay.shape[1] % 4:
        raise ValueError("hay must be a 2-D uint8 tensor of rows a multiple of 4 bytes long")
    n, tn = values.shape
    h = lh.shape[0]
    if masks.shape != values.shape or ln.shape[0] != n or hay.shape[0] != h or tn < 1:
        raise ValueError("values, masks and ln must describe the same needles, hay and lh the same words")
    if block < 1:
        raise ValueError(f"block must be positive, got {block}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no pair-block kernel for device {device}")
    live = _plan_array(plan, n, h, tn, hay.shape[1] // 4)
    operands = tuple(x.contiguous() for x in (values, masks, ln, hay, lh))
    if any(x.device != device for x in operands):
        raise ValueError("kernel operands must be on one device")
    if device.type == "cuda" and operands[3].data_ptr() % 4:
        raise ValueError("hay must be 4-byte aligned")
    if device.type == "cuda":
        tracing.count("uploads.pair_block")
    return PairLaunch(operands, block, live, torch.from_numpy(live).to(device))


@functools.lru_cache(maxsize=16)
def _resident_blocks(index: int) -> int:
    """Blocks of the pair kernel that CUDA device ``index`` holds at once
    (blocks per SM times SMs)."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = cuda_lib.load().ssf_pair_blocks(ctypes.byref(per_sm))
    cuda_lib.check(err, "ssf_pair_blocks")
    return per_sm.value * torch.cuda.get_device_properties(index).multi_processor_count


def run_launch(launch: PairLaunch, count: bool = False):
    """One sweep of a checked launch plan: :func:`pair_block`'s answers.  On
    a card: one zeroed (total, tile counter) pair, in matrix mode the output
    filled with -1, one launch, all in the span
    ``sliceslice.launch.pair_block``."""
    values, masks, ln, hay, lh = launch.operands
    block = launch.block
    device = hay.device
    if device.type == "cpu":
        return _pair_blocks_plain(values, masks, ln, hay, lh, launch.live.tolist(), block, count)
    with tracing.span("sliceslice.launch.pair_block"):
        n, tn = values.shape
        h = lh.shape[0]
        state = torch.zeros((2,), dtype=torch.int32, device=device)  # total, tile counter
        first = None if count else torch.full((n, h), -1, dtype=torch.int32, device=device)
        entries = launch.live.shape[0]
        if entries == 0:
            return state[0] if count else first
        with torch.cuda.device(device):
            err = cuda_lib.load().ssf_pair_block(
                values.data_ptr(), masks.data_ptr(), ln.data_ptr(), n, tn, hay.data_ptr(),
                lh.data_ptr(), h, hay.shape[1] // 4, launch.table.data_ptr(), entries, block,
                _resident_blocks(device.index), None if count else first.data_ptr(),
                state.data_ptr() if count else None, state.data_ptr() + 4,
                torch.cuda.current_stream().cuda_stream,
            )
        cuda_lib.check(err, "ssf_pair_block")
    tracing.count("launches.pair_block")
    return state[0] if count else first


def pair_block(values, masks, ln, hay, lh, plan, block: int, count: bool = False):
    """Every block of an all-pairs plan in one pass.

    ``values``/``masks``: int32 (N, TN) bit patterns of pre-masked probe
    tables; ``ln``: int32 (N,) needle lengths; ``hay``: uint8 (H, WB) the
    words' bytes, zero-padded, WB a multiple of 4; ``lh``: int32 (H,) word
    lengths; ``plan``: host rows ``(i0, j0, tn_b, mi_b)``, one per block
    (``tn_b = 0``: a skipped block, all-false).  Pair (n, h) of a planned
    block reports the smallest ``i <= min(len(h) - len(n), mi_b - 1)`` at
    which every slot ``t < tn_b`` matches word h's window at ``i + 4t``.
    Padded needle rows (len ``2**30``) and padded words (len -1) never
    match.  Returns the int32 (N, H) first matrix, -1 where no match or
    outside a planned block, or with ``count`` the 0-d int32 number of
    matching pairs.  The plan is checked and sent to the device on every
    call (:func:`plan_launch`); a caller that sweeps one plan repeatedly
    keeps the :class:`PairLaunch` and calls :func:`run_launch`, as
    :class:`PairwiseSearcher` does."""
    return run_launch(plan_launch(values, masks, ln, hay, lh, plan, block), count)


class PairwiseSearcher:
    """Preprocess a word list once; sweep every needle against every word.

    ``contains_matrix(haystacks)``: bool[N, H]; ``first_matrix``: int32[N, H]
    with -1 for no match; ``count_matches_device``: the number of matching
    pairs as a 0-d int32 tensor on the device.  ``haystacks=None`` sweeps
    the needles against themselves.  The tables live on ``device``: the
    CUDA kernel runs there, the plain version on the CPU.
    """

    #: retained (kind, haystack-list) cache entries; beyond this the oldest
    #: are evicted, so a service cycling through many haystack lists does
    #: not pin every list and its (N, H) device matrices.
    _HAY_CACHE_CAP = 12

    def __init__(self, needles: Sequence[bytes], block: int = BLOCK, *, device: DeviceLike = "cuda"):
        self.needles = [bytes(w) for w in needles]
        self.block = block
        self.device = resolve_device(device)
        tn = -(-self._bucket(max_len(self.needles)) // 4)
        self._set_tables(*build_probe_table(self.needles, t_max=tn))

    def _set_tables(self, values: np.ndarray, masks: np.ndarray, lengths: np.ndarray) -> None:
        """Needle tables (N, tn) uint32 and lengths (N,), uploaded to the
        searcher's device (values re-masked: the kernel compares them
        masked)."""
        masks = np.asarray(masks, np.uint32)
        values = np.asarray(values, np.uint32) & masks
        self.tn = values.shape[1]
        self._values = table_bits(values, self.device)
        self._masks = table_bits(masks, self.device)
        self._ln_host = np.asarray(lengths, np.int32)
        self._ln = torch.from_numpy(self._ln_host.copy()).to(self.device)
        self._hay_cache: dict = {}

    def _cache_get(self, kind: str, haystacks):
        # id()-keyed with a strong reference kept in the value, so a freed
        # list's address can never alias a new one.
        key = (kind, id(haystacks) if haystacks is not None else None)
        hit = self._hay_cache.get(key)
        if hit is not None and hit[0] is haystacks:
            return hit[1]
        return None

    def _cache_put(self, kind: str, haystacks, value):
        key = (kind, id(haystacks) if haystacks is not None else None)
        self._hay_cache.pop(key, None)
        self._hay_cache[key] = (haystacks, value)  # dicts keep insert order
        while len(self._hay_cache) > self._HAY_CACHE_CAP:
            self._hay_cache.pop(next(iter(self._hay_cache)))
        return value

    def _pack_hay(self, haystacks: Optional[Sequence[bytes]]):
        """(hay uint8 (H, WB), lh int32 (H,), lh on the host, mi) on the
        device: each word's bytes zero-padded to ``mi + 4*tn`` rounded up to
        whole 32-bit words."""
        hit = self._cache_get("pack", haystacks)
        if hit is not None:
            return hit
        hs = self.needles if haystacks is None else [bytes(w) for w in haystacks]
        mi = self._bucket(max_len(hs))
        width = -(-(mi + 4 * self.tn) // 4) * 4
        arr, lens = pack_words(hs, width)
        out = (torch.from_numpy(arr).to(self.device), torch.from_numpy(lens).to(self.device), lens, mi)
        return self._cache_put("pack", haystacks, out)

    @staticmethod
    def _bucket(x: int) -> int:
        for b in (2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256):
            if x <= b:
                return b
        return -(-x // 64) * 64

    def _plan(self, haystacks=None):
        """Static block plan: ``(i0, j0, tn_b, mi_b)`` per block pair, the
        JAX package's plan.  When word lists are length-sorted (the
        reference sorts its sweep the same way, tests/i386.rs:49), each
        block's longest word is far below the global longest: probe widths
        and scan lengths are bucketed per block pair, and needle blocks
        whose shortest needle exceeds the word block's longest word are
        skipped outright (``(i0, j0, 0, 0)``: all-false)."""
        hit = self._cache_get("plan", haystacks)
        if hit is not None:
            return hit
        _hay, _lh, lh_np, _mi = self._pack_hay(haystacks)
        ln_np = self._ln_host
        b = self.block
        plan = []
        for i0 in range(0, ln_np.shape[0], b):
            ln_blk = ln_np[i0 : i0 + b]
            tn_b = -(-self._bucket(max(int(ln_blk.max()), 1)) // 4)
            for j0 in range(0, lh_np.shape[0], b):
                lh_blk = lh_np[j0 : j0 + b]
                if int(ln_blk.min()) > int(lh_blk.max()):
                    plan.append((i0, j0, 0, 0))  # skipped
                    continue
                plan.append((i0, j0, tn_b, self._bucket(max(int(lh_blk.max()), 1))))
        return self._cache_put("plan", haystacks, tuple(plan))

    def _launch_plan(self, haystacks=None) -> PairLaunch:
        """The sweep's checked plan and its device table, built once per
        haystack list."""
        hit = self._cache_get("launch", haystacks)
        if hit is not None:
            return hit
        hay, lh, _lh_np, _mi = self._pack_hay(haystacks)
        launch = plan_launch(self._values, self._masks, self._ln, hay, lh, self._plan(haystacks), self.block)
        return self._cache_put("launch", haystacks, launch)

    def _sweep(self, haystacks, count: bool):
        return run_launch(self._launch_plan(haystacks), count)

    def _first_device(self, haystacks=None) -> torch.Tensor:
        hit = self._cache_get("mat", haystacks)
        if hit is not None:
            return hit
        return self._cache_put("mat", haystacks, self._sweep(haystacks, count=False))

    def contains_matrix(self, haystacks=None) -> np.ndarray:
        return (self._first_device(haystacks) >= 0).cpu().numpy()

    def first_matrix(self, haystacks=None) -> np.ndarray:
        return self._first_device(haystacks).cpu().numpy()

    def count_matches_device(self, haystacks=None) -> torch.Tensor:
        """Total match count across all pairs, device-resident (the bench
        checksum: forces full evaluation, fetches one scalar).  After the
        first call for a haystack list: one zeroed counter pair, one
        launch."""
        return self._sweep(haystacks, count=True)


def pairwise_contains_all(words: Sequence[bytes], *, device: DeviceLike = "cuda") -> np.ndarray:
    """bool[N, N] containment matrix of a word list against itself (the
    reference short-haystack sweep shape)."""
    return PairwiseSearcher(words, device=device).contains_matrix()
