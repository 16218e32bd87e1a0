"""Kernel wrappers of the find, count and positions paths:
``batched_find``, ``batched_count``, ``match_bitmap_counted`` (and
``match_bitmap``), ``item_ranks``, ``compact_window`` (capped as
``compact_positions``) and ``memchr_find``.

Each wrapper launches its hand-written CUDA kernel (``csrc/find.cu``,
``csrc/positions.cu``) for a tensor on a CUDA device and runs its plain
PyTorch version, defined beside it with the same signature, for a tensor
on the CPU.  Any other device raises; nothing falls back from the card to
the CPU.  On the card each wrapper's call is the span
``sliceslice.launch.<wrapper>`` (:mod:`..utils.tracing`), from its entry to
its kernel's return: operand checks, output buffers, the queue plan and
the launch; each launch counts ``launches.<wrapper>``.

``batched_find`` replaces ``sliceslice_tpu/ops/scan_kernel.py``'s
``batched_find_cols`` over the Pallas find kernel, ``batched_count`` its
``batched_count_cols`` over the Pallas count kernel, ``memchr_find`` its
``memchr_find_cols``, ``match_bitmap_counted`` the plain-XLA
``xla_backend.match_bitmap_batched`` of the positions path (linear here)
and ``item_ranks`` with ``compact_window`` its ``compact_positions_batched``
(``compact_positions`` keeps that contract; ``compact_window`` also packs
every row's offsets into one buffer).  The find,
count and bitmap kernels take work items (a row, or for count and bitmap a
group of rows, and a chunk of positions) from a queue in chunk-major order
(:func:`plan_queue`, :func:`plan_grouped`).  The haystack is the flat
layout of :mod:`.layout`: positions are byte offsets into it, and its zero
halo must cover ``needed_halo_for_t(t)`` bytes past the last valid
position.  Positions whose probe windows would run past the buffer are
never evaluated, by either version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import config
from ..config import SENTINEL
from ..utils import tracing
from . import cuda_lib
from .scan_math import (
    first_offsets,
    match_bits,
    match_counts,
    popcount32,
    position_limit,
    table_bits,
)

#: Probe-table widths up to this are exact width groups in
#: ``BatchedSearcher``; wider tables are bucketed (the JAX unroll limit).
PROBE_UNROLL = 8
#: Widest probe table the find and count kernels take (``MAX_NEEDLE_LEN / 4``).
MAX_T = 512

#: Positions the ablation kernel evaluates per block step (4 per thread),
#: positions the queue kernels evaluate per block step (16 per thread),
#: bytes the memchr kernel reads per block step (csrc/scan_common.cuh
#: kFindTile / kWideTile, csrc/find.cu kMemchrTile).
FIND_TILE = 1024
WIDE_TILE = 4096
MEMCHR_TILE = 4096
#: Least positions one block owns in the span plan: below this, extra
#: blocks cost more to schedule than the parallelism they add.
MIN_SPAN = 1 << 16
#: Resident blocks per SM times waves: the grid the span plan aims for.
BLOCKS_PER_SM = 16
#: Positions per item of the find and count kernels' work queues, multiples
#: of WIDE_TILE: of 16 K, 32 K and 64 K, the smallest that loses no more
#: than the spread on the i386 sweep (PERF.md).  Count's items never
#: overshoot, so it gains from fewer, longer ones; find's overshoot each
#: row's first match.  The bitmap walks every position as count does, so
#: it takes count's chunk; its items are also the compaction's.
FIND_CHUNK = 1 << 15
COUNT_CHUNK = 1 << 16
BITMAP_CHUNK = COUNT_CHUNK
#: Widest table the find kernel walks at a width fixed at compile time
#: (csrc/scan_common.cuh kMaxRegT); wider ones share one instantiation.
MAX_REG_T = 4
#: The same for the count and bitmap kernels (csrc/queue.cuh kMaxGroupT),
#: which group rows only at such widths.  Their tables wider than
#: MAX_REG_T filter each position on slots 0 and 1 before the exact walk.
MAX_GROUP_T = PROBE_UNROLL
#: Rows per item of the count and bitmap kernels when a launch groups its
#: rows (csrc/queue.cuh kGroupRows; else 1): the rows of an item share each
#: wide tile's corpus words and slot-0 windows.
GROUP_ROWS = 8
#: Items per resident block a launch keeps when it groups rows: with
#: fewer, a launch takes fewer rows per item, so that it still spreads over
#: the card.
ITEMS_PER_BLOCK = 2
#: Rows a block of the rank kernel takes at once (csrc/positions.cu: a warp
#: per row).
RANK_ROWS = 8
#: The queue kernels' modes (csrc/find.cu ``Mode``).
FIND, COUNT, BITMAP = 0, 1, 2


def chunk_of(mode: int) -> int:
    """The work-queue chunk of ``mode``, read from the module's constants
    at each launch (so a script may set them)."""
    return {FIND: FIND_CHUNK, COUNT: COUNT_CHUNK, BITMAP: BITMAP_CHUNK}[mode]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_block(n: int, t: int) -> tuple[int, int]:
    """(nblk, n_pad) for an n-needle width-t table, as the JAX package plans
    it: the padded row count of device-resident tables.  The CUDA kernel has
    no needle blocks; padding rows keeps both packages' tables alike."""
    cap = max(8, min(256, _round_up(2048 // max(t, 1), 8)))
    nblk = min(config.NEEDLE_BLOCK, cap, _round_up(max(n, 1), 8))
    return nblk, _round_up(max(n, 1), nblk)


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_spans(n_pos: int, rows: int, tile: int, sms: int) -> tuple[int, int]:
    """(span, n_spans): positions per block (a multiple of ``tile``) and
    blocks per row, so that ``rows * n_spans`` fills ``sms`` SMs without
    giving a block fewer than :data:`MIN_SPAN` positions."""
    want = max(1, -(-sms * BLOCKS_PER_SM // max(rows, 1)))
    most = max(1, n_pos // MIN_SPAN)
    span = _round_up(-(-n_pos // min(want, most)), tile)
    return span, -(-n_pos // span)


class QueuePlan(NamedTuple):
    """One launch of a queue kernel (csrc/find.cu): a persistent
    grid of ``grid`` blocks takes ``n_items`` items from a zeroed int32
    counter; item ``i`` is positions ``[c * chunk, (c + 1) * chunk)`` of the
    ``group`` rows ``group * (i % groups) ..``, with ``groups = ceil(rows /
    group)`` and ``c = i // groups``, each cut at its row's limit ``min(ends
    - base, n_pos)``, so chunk ``c`` of every group comes before chunk ``c +
    1`` of any group."""

    n_words: int
    n_pos: int
    chunk: int
    n_chunks: int
    n_items: int
    grid: int
    group: int = 1


def plan_queue(nbytes: int, t: int, rows: int, resident: int, chunk: int,
               group: int = 1) -> QueuePlan:
    """The work queue of ``rows`` width-``t`` rows, ``group`` rows an item,
    over an ``nbytes`` haystack for a card that holds ``resident`` blocks
    at once: chunks are ``chunk`` positions rounded up to whole wide tiles,
    doubled while the (row, chunk) count would leave int32 (the bitmap's
    item counts hold one per row and chunk)."""
    n_pos = position_limit(nbytes, t)
    chunk = _round_up(max(int(chunk), 1), WIDE_TILE)
    while rows * -(-n_pos // chunk) + resident >= 2**31:
        chunk *= 2
    n_chunks = -(-n_pos // chunk)
    n_items = -(-rows // group) * n_chunks
    return QueuePlan(nbytes // 4, n_pos, chunk, n_chunks, n_items, max(1, min(resident, n_items)),
                     group)


def plan_grouped(nbytes: int, t: int, rows: int, chunk: int, resident) -> QueuePlan:
    """The count and bitmap kernels' queue (:func:`plan_queue`):
    :data:`GROUP_ROWS` rows per item where the launch's shape allows it (a
    table of at most :data:`MAX_GROUP_T` slots, at least that many rows,
    and still :data:`ITEMS_PER_BLOCK` items per resident block), else one.
    ``resident(group)`` is the blocks the card holds at once of the kernel
    taking ``group`` rows per item."""
    if t <= MAX_GROUP_T and rows >= GROUP_ROWS:
        plan = plan_queue(nbytes, t, rows, resident(GROUP_ROWS), chunk, GROUP_ROWS)
        if plan.n_items >= ITEMS_PER_BLOCK * resident(GROUP_ROWS):
            return plan
    return plan_queue(nbytes, t, rows, resident(1), chunk)


@functools.lru_cache(maxsize=64)
def _resident_blocks(index: int, mode: int, t_class: int, group: int) -> int:
    """Blocks of the ``mode`` queue kernel's width-``t_class``
    instantiation taking ``group`` rows per item that CUDA device ``index``
    holds at once (blocks per SM times SMs)."""
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = cuda_lib.load().ssf_queue_blocks(mode, t_class, group, ctypes.byref(per_sm))
    cuda_lib.check(err, "ssf_queue_blocks")
    return per_sm.value * _sm_count(index)


def _check_hay(hay: torch.Tensor) -> None:
    if hay.dtype != torch.uint8 or hay.dim() != 1 or not hay.is_contiguous():
        raise ValueError("haystack must be a contiguous 1-D uint8 tensor")


def _check_base(hay: torch.Tensor, base: int) -> int:
    base = int(base)
    if base < 0 or base + hay.numel() > SENTINEL:
        raise ValueError(
            f"base={base} puts positions of a {hay.numel()}-byte layout "
            "outside int32"
        )
    return base


def _cuda_ready(*tensors: torch.Tensor) -> None:
    """The kernels take contiguous tensors on one CUDA device, the
    haystack 16-byte aligned and a multiple of 16 bytes long."""
    hay = tensors[0]
    for x in tensors:
        if x.device != hay.device or not x.is_contiguous():
            raise ValueError("kernel operands must be contiguous and on one device")
    if hay.data_ptr() % 16 or hay.numel() % 16:
        raise ValueError("haystack buffer must be 16-byte aligned and sized")


def _launch_span(wrapper):
    """``wrapper`` whose calls on a CUDA tensor run in the span
    ``sliceslice.launch.<wrapper>``; its plain versions' are not spans."""
    name = "sliceslice.launch." + wrapper.__name__

    @functools.wraps(wrapper)
    def call(x, *args, **kwargs):
        if tracing.enabled() and getattr(x, "is_cuda", False):
            with tracing.span(name):
                return wrapper(x, *args, **kwargs)
        return wrapper(x, *args, **kwargs)

    return call


def _n_real(n_real, n: int) -> int:
    return n if n_real is None else max(0, min(int(n_real), n))


def _operands(hay, values, masks, ends, base):
    """The checked operands of the find and count wrappers: ``base`` and
    the tables as int32 tensors on ``hay``'s device (numpy tables re-masked,
    as the JAX wrappers do)."""
    _check_hay(hay)
    base = _check_base(hay, base)
    device = hay.device
    if isinstance(values, np.ndarray) and isinstance(masks, np.ndarray):
        values = np.asarray(values, np.uint32) & np.asarray(masks, np.uint32)
    values = table_bits(values, device)
    masks = table_bits(masks, device)
    ends = torch.as_tensor(ends, dtype=torch.int32).to(device).reshape(-1)
    n, t = values.shape
    if masks.shape != values.shape or ends.shape[0] != n:
        raise ValueError("values, masks and ends must describe the same rows")
    if not 1 <= t <= MAX_T:
        raise ValueError(f"probe table width {t} outside 1..{MAX_T}")
    return base, values, masks, ends


def _queue_plan(mode: int, hay, t: int, rows: int) -> QueuePlan:
    """The work queue of one ``mode`` launch over ``rows`` rows, for the
    card that holds ``hay``: find takes one row per item, count and bitmap
    as many as :func:`plan_grouped` allows."""
    widest = MAX_REG_T if mode == FIND else MAX_GROUP_T
    resident = functools.partial(_resident_blocks, hay.device.index, mode, min(t, widest + 1))
    if mode == FIND:
        return plan_queue(hay.numel(), t, rows, resident(1), chunk_of(mode))
    return plan_grouped(hay.numel(), t, rows, chunk_of(mode), resident)


def _launch_queue(mode: int, plan: QueuePlan, hay, values, masks, ends, out, base: int,
                  n_real: int, bits=None) -> bool:
    """One launch of the ``mode`` queue kernel over rows below ``n_real``
    on ``plan``, writing into ``out`` (and, for the bitmap, ``bits``);
    False when there is nothing to scan."""
    values, masks, ends = values.contiguous(), masks.contiguous(), ends.contiguous()
    _cuda_ready(hay, values, masks, ends)
    if n_real == 0 or plan.n_items == 0:
        return False
    queue = torch.zeros((1,), dtype=torch.int32, device=hay.device)
    with torch.cuda.device(hay.device):
        err = cuda_lib.load().ssf_queue(
            mode, hay.data_ptr(), plan.n_words, plan.n_pos, values.data_ptr(), masks.data_ptr(),
            ends.data_ptr(), out.data_ptr(), n_real, values.shape[1], base, plan.chunk, plan.group,
            plan.n_items, plan.grid, queue.data_ptr(), 0 if bits is None else bits.data_ptr(),
            0 if bits is None else bits.shape[1], torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(err, "ssf_queue")
    return True


def _count_rows(wrapper: str, plan: QueuePlan, t: int, n_real: int) -> None:
    """The counters of one count or bitmap launch over ``n_real`` rows:
    ``launches.<wrapper>``; its rows under ``tiled_rows`` or
    ``single_rows`` by the plan's rows per item, and under
    ``two_slot_rows`` too where the table's width takes the two-slot
    filter (csrc/queue.cuh kFilterSlots<T> == 2: T from MAX_REG_T + 1 to
    MAX_GROUP_T)."""
    tracing.count(f"launches.{wrapper}")
    tracing.count(f"{'tiled_rows' if plan.group > 1 else 'single_rows'}.{wrapper}", n_real)
    if MAX_REG_T < t <= MAX_GROUP_T:
        tracing.count(f"two_slot_rows.{wrapper}", n_real)


def batched_find_plain(hay, values, masks, ends, base=0, n_real=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`batched_find` (same signature and
    answers; tables as int32 bit-pattern tensors on ``hay``'s device)."""
    n, t = values.shape
    n_real = _n_real(n_real, n)
    out = torch.full((n,), SENTINEL, dtype=torch.int32, device=hay.device)
    if n_real == 0:
        return out
    bound = position_limit(hay.numel(), t)
    limits = (ends[:n_real].to(torch.int64) - base).clamp(max=bound)
    first = first_offsets(hay, values[:n_real], masks[:n_real], limits)
    out[:n_real] = torch.where(first < SENTINEL, first + base, SENTINEL).to(torch.int32)
    return out


@_launch_span
def batched_find(hay, values, masks, ends, base=0, n_real=None) -> torch.Tensor:
    """First-match offsets (int32[N], SENTINEL when absent) of N probe
    programs over the flat haystack ``hay``.

    Row ``n < n_real`` reports the smallest ``p`` with ``p + base <
    ends[n]`` at which every slot ``i`` satisfies ``(window(p + 4i) &
    masks[n, i]) == values[n, i]``, as ``p + base``; rows at or past
    ``n_real`` are never scanned and report SENTINEL.  ``values``/``masks``
    are uint32 numpy tables (re-masked here, as the JAX wrapper does) or
    int32 bit-pattern tensors; ``ends`` are int32, in the same frame as the
    reported offsets.  Padded rows (mask 0, end 0) report SENTINEL.

    Any table of masked slots is answered exactly: every slot's mask
    applies and a mask-0 slot is true, so rows of different widths may
    share one table, and a final mask need not be a byte prefix.  (The JAX
    ``batched_find_cols`` refuses a mixed-width table: its TPU kernel
    compares non-final slots unmasked.)"""
    base, values, masks, ends = _operands(hay, values, masks, ends, base)
    device = hay.device
    if device.type == "cpu":
        return batched_find_plain(hay, values, masks, ends, base, n_real)
    if device.type != "cuda":
        raise ValueError(f"no find kernel for device {device}")
    n, t = values.shape
    n_real = _n_real(n_real, n)
    out = torch.full((n,), SENTINEL, dtype=torch.int32, device=device)
    plan = _queue_plan(FIND, hay, t, n_real)
    if _launch_queue(FIND, plan, hay, values, masks, ends, out, base, n_real):
        tracing.count("launches.batched_find")
    return out


def batched_count_plain(hay, values, masks, ends, base=0, n_real=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`batched_count` (same signature and
    answers; tables as int32 bit-pattern tensors on ``hay``'s device)."""
    n, t = values.shape
    n_real = _n_real(n_real, n)
    out = torch.zeros((n,), dtype=torch.int32, device=hay.device)
    if n_real == 0:
        return out
    bound = position_limit(hay.numel(), t)
    limits = (ends[:n_real].to(torch.int64) - base).clamp(max=bound)
    out[:n_real] = match_counts(hay, values[:n_real], masks[:n_real], limits).to(torch.int32)
    return out


@_launch_span
def batched_count(hay, values, masks, ends, base=0, n_real=None) -> torch.Tensor:
    """Overlapping match counts (int32[N]) of N probe programs over the
    flat haystack ``hay``, with the operands of :func:`batched_find`.

    Row ``n < n_real`` reports how many positions ``p`` with ``p + base <
    ends[n]`` satisfy every slot; the counts do not depend on ``base``
    otherwise.  Rows at or past ``n_real`` are never scanned and report 0,
    as do padded rows (mask 0, end 0).  ``ends`` must exclude positions
    past ``length - k + 1``: a needle ending in zero bytes also matches in
    the layout's zero halo.  Any table of masked slots is answered
    exactly, as by :func:`batched_find`."""
    base, values, masks, ends = _operands(hay, values, masks, ends, base)
    device = hay.device
    if device.type == "cpu":
        return batched_count_plain(hay, values, masks, ends, base, n_real)
    if device.type != "cuda":
        raise ValueError(f"no count kernel for device {device}")
    n, t = values.shape
    n_real = _n_real(n_real, n)
    out = torch.zeros((n,), dtype=torch.int32, device=device)
    plan = _queue_plan(COUNT, hay, t, n_real)
    if _launch_queue(COUNT, plan, hay, values, masks, ends, out, base, n_real):
        _count_rows("batched_count", plan, t, n_real)
    return out


def bitmap_words(nbytes: int, t: int) -> int:
    """Words per row of :func:`match_bitmap`'s output over an ``nbytes``
    haystack and width-``t`` tables: one bit per evaluated position, in
    whole 16-byte groups (the compaction kernel reads 4 words at a time)."""
    return _round_up(-(-position_limit(nbytes, t) // 32), 4)


def match_bitmap_plain(hay, values, masks, ends, base=0, n_real=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`match_bitmap` (same signature and
    answers; tables as int32 bit-pattern tensors on ``hay``'s device)."""
    n, t = values.shape
    n_real = _n_real(n_real, n)
    bound = position_limit(hay.numel(), t)
    out = torch.zeros((n, bitmap_words(hay.numel(), t)), dtype=torch.int32, device=hay.device)
    if n_real == 0:
        return out
    limits = (ends[:n_real].to(torch.int64) - base).clamp(max=bound)
    out[:n_real] = match_bits(hay, values[:n_real], masks[:n_real], limits, out.shape[1])
    return out


def match_bitmap(hay, values, masks, ends, base=0, n_real=None) -> torch.Tensor:
    """Linear match bitmaps (int32[N, W] of uint32 bit patterns, ``W =
    bitmap_words(hay.numel(), t)``) of N probe programs over the flat
    haystack, with the operands of :func:`batched_find`.

    Bit ``b`` of word ``w`` of row ``n < n_real`` is set iff position ``p =
    32w + b`` satisfies every slot and ``p + base < ends[n]``: positions
    are layout offsets, ``base`` moves only the end bound.  Rows at or past
    ``n_real`` are never scanned and stay 0.  As for counts, ``ends`` must
    exclude positions past ``length - k + 1``.  Any table of masked slots
    is answered exactly, as by :func:`batched_find`.  The bitmaps of
    :func:`match_bitmap_counted`, whose launches it counts."""
    return match_bitmap_counted(hay, values, masks, ends, base, n_real)[0]


def item_counts_of(words: torch.Tensor, chunk: int, n_chunks: int) -> torch.Tensor:
    """int32[n_chunks, N]: the set bits of each row of the linear bitmaps
    ``words`` in each chunk of ``chunk`` positions (a multiple of 128)."""
    n, w = words.shape
    cw = chunk // 32
    pc = torch.nn.functional.pad(popcount32(words), (0, n_chunks * cw - w))
    return pc.view(n, n_chunks, cw).sum(dim=2, dtype=torch.int32).T.contiguous()


def match_bitmap_counted_plain(hay, values, masks, ends, base=0, n_real=None):
    """Plain PyTorch version of :func:`match_bitmap_counted` (same
    signature and answers)."""
    n, t = values.shape
    words = match_bitmap_plain(hay, values, masks, ends, base, n_real)
    plan = plan_queue(hay.numel(), t, _n_real(n_real, n), 1, BITMAP_CHUNK)
    return words, item_counts_of(words, plan.chunk, plan.n_chunks), plan.chunk


@_launch_span
def match_bitmap_counted(hay, values, masks, ends, base=0, n_real=None):
    """:func:`match_bitmap`'s bitmaps and the match count of each of the
    bitmap kernel's queue items, from one launch: ``(words int32[N, W],
    item_counts int32[n_chunks, N], chunk)``, where ``item_counts[c, n]``
    is the number of set bits of row ``n`` at positions ``[c * chunk, (c +
    1) * chunk)``.  A row's total is the sum over ``c``; the exclusive
    cumsum over ``c`` ranks each item's first match within its row: both
    are :func:`item_ranks`'."""
    base, values, masks, ends = _operands(hay, values, masks, ends, base)
    device = hay.device
    if device.type == "cpu":
        return match_bitmap_counted_plain(hay, values, masks, ends, base, n_real)
    if device.type != "cuda":
        raise ValueError(f"no match-bitmap kernel for device {device}")
    n, t = values.shape
    n_real = _n_real(n_real, n)
    plan = _queue_plan(BITMAP, hay, t, n_real)
    words = torch.zeros((n, bitmap_words(hay.numel(), t)), dtype=torch.int32, device=device)
    counts = torch.zeros((plan.n_chunks, n_real), dtype=torch.int32, device=device)
    if _launch_queue(BITMAP, plan, hay, values, masks, ends, counts, base, n_real, words):
        _count_rows("match_bitmap_counted", plan, t, n_real)
    if n_real < n:
        counts = torch.nn.functional.pad(counts, (0, n - n_real))
    return words, counts, plan.chunk


def compact_positions_plain(words, item_counts, chunk, cap):
    """Plain PyTorch version of :func:`compact_positions` (same signature
    and answers).  It reads only ``words``: counts are popcounts, and only
    the words up to a row's ``cap``-th match are expanded (nonzero words,
    then bits), so a dense row costs no more than a sparse one."""
    n = words.shape[0]
    cap = int(cap)
    offsets = torch.full((n, cap), SENTINEL, dtype=torch.int32, device=words.device)
    compact_window_plain(words, item_counts, None, chunk, offsets, cap=cap)
    return popcount32(words).sum(dim=1, dtype=torch.int32), offsets


def _check_compaction(words, item_counts, chunk) -> None:
    """The operands every compaction wrapper takes: :func:`match_bitmap_counted`'s
    words, item counts and chunk, on one device."""
    if (words.dim() != 2 or words.dtype != torch.int32 or item_counts.dtype != torch.int32
            or item_counts.dim() != 2 or item_counts.shape[1] != words.shape[0]
            or words.shape[1] % 4 or int(chunk) % WIDE_TILE or item_counts.device != words.device):
        raise ValueError("the compaction takes match_bitmap_counted's words, item counts and chunk")


def _cuda_operand(x, what: str, shape: tuple, dtype=torch.int32, device=None) -> None:
    """A kernel operand: contiguous, of ``dtype`` and ``shape``, on ``device``."""
    if (x.dtype != dtype or tuple(x.shape) != tuple(shape) or not x.is_contiguous()
            or (device is not None and x.device != device)):
        raise ValueError(f"{what} must be a contiguous {dtype} tensor of shape {tuple(shape)} "
                         f"on {device}")


def item_ranks_plain(item_counts, offsets=None):
    """Plain PyTorch version of :func:`item_ranks` (same signature and
    answers)."""
    counts = item_counts.sum(dim=0, dtype=torch.int32)
    first = torch.cumsum(item_counts, dim=0, dtype=torch.int32) - item_counts
    if offsets is not None:
        cols = torch.arange(offsets.shape[1], device=offsets.device)
        offsets.masked_fill_(cols[None, :] >= counts[:, None], SENTINEL)
    return counts, first


@_launch_span
def item_ranks(item_counts, offsets=None):
    """``(counts int32[N], first_rank int32[n_chunks, N])`` of the bitmap
    kernel's per-item match counts (``item_counts`` int32[n_chunks, N] of
    :func:`match_bitmap_counted`): each row's match count, and each item's
    first rank within its row, the exclusive cumsum of its row's earlier
    items.  With ``offsets`` (int32[N, cap]), each row's tail past its
    count, ``offsets[n, min(counts[n], cap):]``, is set to SENTINEL in
    place: the rest is the capped compaction's (:func:`compact_positions`).
    One launch of the rank kernel (``csrc/positions.cu``) on the card."""
    device = item_counts.device
    if device.type == "cpu":
        return item_ranks_plain(item_counts, offsets)
    if device.type != "cuda":
        raise ValueError(f"no rank kernel for device {device}")
    if item_counts.dim() != 2:
        raise ValueError("item_counts must be int32[n_chunks, N]")
    n_chunks, n = item_counts.shape
    _cuda_operand(item_counts, "item_counts", (n_chunks, n))
    if offsets is not None:
        _cuda_operand(offsets, "offsets", (n, offsets.shape[-1]), device=device)
    counts = torch.empty((n,), dtype=torch.int32, device=device)
    first = torch.empty((n_chunks, n), dtype=torch.int32, device=device)
    if n == 0:
        return counts, first
    grid = min(-(-n // RANK_ROWS), BLOCKS_PER_SM * _sm_count(device.index))
    with torch.cuda.device(device):
        err = cuda_lib.load().ssf_item_ranks(
            item_counts.data_ptr(), n_chunks, n, counts.data_ptr(), first.data_ptr(),
            0 if offsets is None else offsets.data_ptr(), 0 if offsets is None else offsets.shape[1],
            grid, torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(err, "ssf_item_ranks")
    tracing.count("launches.item_ranks")
    return counts, first


def _rank_windows(n: int, cap, row_base, window, device):
    """Per row, int64 ``(lo, hi, dst)``: the row's window of ranks ``[lo,
    hi)`` and where its rank 0 would go in the flat output."""
    if cap is not None:
        rows = torch.arange(n, dtype=torch.int64, device=device)
        return torch.zeros_like(rows), torch.full_like(rows, int(cap)), rows * int(cap)
    base = row_base.to(device=device, dtype=torch.int64)
    lo, hi = window
    return lo - base, hi - base, base - lo


def compact_window_plain(words, item_counts, first_rank, chunk, out, cap=None, row_base=None,
                         window=(0, 0)):
    """Plain PyTorch version of :func:`compact_window` (same signature and
    answers).  It reads only ``words``: ranks are popcounts, and only the
    words holding a rank in their row's window are expanded (nonzero words,
    then bits)."""
    lo, hi, dst = _rank_windows(words.shape[0], cap, row_base, window, words.device)
    pc = popcount32(words).to(torch.int64)
    before = torch.cumsum(pc, dim=1) - pc  # the row's matches in earlier words
    r, w = torch.nonzero((words != 0) & (before < hi[:, None]) & (before + pc > lo[:, None]),
                         as_tuple=True)
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words[r, w].to(torch.int64)[:, None] >> shifts) & 1
    rank = before[r, w][:, None] + torch.cumsum(bits, dim=1) - bits
    k, b = torch.nonzero((bits != 0) & (rank >= lo[r][:, None]) & (rank < hi[r][:, None]),
                         as_tuple=True)
    out.view(-1)[dst[r[k]] + rank[k, b]] = (32 * w[k] + b).to(torch.int32)
    return out


@_launch_span
def compact_window(words, item_counts, first_rank, chunk, out, cap=None, row_base=None,
                   window=(0, 0)):
    """Write into ``out`` the match offsets of each row's window of ranks,
    from the linear bitmaps ``words`` and their ``item_counts`` and
    ``chunk`` (:func:`match_bitmap_counted`'s) and ``first_rank``
    (:func:`item_ranks`'), in one of two modes:

    * capped (``cap`` given): ranks ``[0, cap)`` of row ``n`` at ``out[n,
      r]``, ``out`` int32[N, cap]; slots past the row's count are left as
      they are (:func:`item_ranks` fills them);
    * packed (``row_base`` given, int64[N], the exclusive cumsum of the
      rows' counts): rank ``r`` of row ``n`` is packed rank ``row_base[n] +
      r``, and the packed ranks ``[lo, hi) = window`` go to ``out[0 : hi -
      lo]``, ``out`` int32[hi - lo]: every row's offsets, ascending, row
      after row, a window at a time.

    One launch of the compaction kernel (``csrc/positions.cu``) on the
    card; returns ``out``."""
    if (cap is None) == (row_base is None):
        raise ValueError("compact_window takes cap (capped mode) or row_base (packed mode)")
    _check_compaction(words, item_counts, chunk)
    n = words.shape[0]
    lo, hi = (int(x) for x in window)
    if cap is not None:
        cap = int(cap)
        if cap < 0:
            raise ValueError(f"cap={cap} is negative")
        shape = (n, cap)
    elif not 0 <= lo <= hi:
        raise ValueError(f"window {window} is not a range of ranks")
    else:
        shape = (hi - lo,)
    if tuple(out.shape) != shape or out.dtype != torch.int32:
        raise ValueError(f"out must be int32 of shape {shape}")
    device = words.device
    if device.type == "cpu":
        return compact_window_plain(words, item_counts, first_rank, chunk, out, cap, row_base, window)
    if device.type != "cuda":
        raise ValueError(f"no compaction kernel for device {device}")
    for x, what, want in ((words, "words", words.shape), (item_counts, "item_counts", item_counts.shape),
                          (first_rank, "first_rank", item_counts.shape), (out, "out", shape)):
        _cuda_operand(x, what, want, device=device)
    if row_base is not None:
        _cuda_operand(row_base, "row_base", (n,), torch.int64, device)
    if words.data_ptr() % 16:
        raise ValueError("bitmap buffer must be 16-byte aligned")
    n_items = item_counts.numel()
    if n_items == 0 or (hi == lo if cap is None else cap == 0):
        return out
    grid = min(n_items, BLOCKS_PER_SM * _sm_count(device.index))
    with torch.cuda.device(device):
        err = cuda_lib.load().ssf_compact_positions(
            words.data_ptr(), words.shape[1], n, n_items, int(chunk), item_counts.data_ptr(),
            first_rank.data_ptr(), 0 if cap is None else cap,
            0 if row_base is None else row_base.data_ptr(), lo, hi, out.data_ptr(), grid,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(err, "ssf_compact_positions")
    tracing.count("launches.compact_window")
    return out


def compact_positions(words, item_counts, chunk, cap):
    """``(counts int32[N], offsets int32[N, cap])`` of linear match bitmaps
    (the JAX ``compact_positions_batched`` contract): each row's match
    count and its ``cap`` earliest offsets, ascending, SENTINEL past the
    count, on the bitmaps' device.  ``words``, ``item_counts`` and
    ``chunk`` are :func:`match_bitmap_counted`'s.  On the card: one
    :func:`item_ranks` launch (counts, first ranks, the SENTINEL tail) and
    one capped :func:`compact_window` launch, into buffers from
    ``torch.empty``."""
    cap = int(cap)
    if cap < 0:
        raise ValueError(f"cap={cap} is negative")
    device = words.device
    if device.type == "cpu":
        return compact_positions_plain(words, item_counts, chunk, cap)
    if device.type != "cuda":
        raise ValueError(f"no compaction kernel for device {device}")
    _check_compaction(words, item_counts, chunk)
    offsets = torch.empty((words.shape[0], cap), dtype=torch.int32, device=device)
    counts, first = item_ranks(item_counts, offsets)
    compact_window(words, item_counts, first, chunk, offsets, cap=cap)
    return counts, offsets


def memchr_find_plain(hay, byte, end, base=0) -> torch.Tensor:
    """Plain PyTorch version of :func:`memchr_find`."""
    lim = min(int(end) - base, hay.numel())
    if lim <= 0:
        return torch.tensor(SENTINEL, dtype=torch.int32, device=hay.device)
    hit = hay[:lim] == (int(byte) & 0xFF)
    first = hit.to(torch.uint8).argmax().to(torch.int64)
    return torch.where(hit.any(), first + base, SENTINEL).to(torch.int32)


@_launch_span
def memchr_find(hay, byte, end, base=0) -> torch.Tensor:
    """First offset (0-d int32, SENTINEL when absent) of one byte value in
    the flat haystack: the smallest ``p`` with ``p + base < end`` and
    ``hay[p] == byte``, as ``p + base``."""
    _check_hay(hay)
    base = _check_base(hay, base)
    device = hay.device
    if device.type == "cpu":
        return memchr_find_plain(hay, byte, end, base)
    if device.type != "cuda":
        raise ValueError(f"no memchr kernel for device {device}")
    _cuda_ready(hay)
    out = torch.full((1,), SENTINEL, dtype=torch.int32, device=device)
    lim = min(int(end) - base, hay.numel())
    if lim <= 0:
        return out[0]
    lib = cuda_lib.load()
    with torch.cuda.device(device):
        span, n_spans = plan_spans(lim, 1, MEMCHR_TILE, _sm_count(torch.cuda.current_device()))
        err = lib.ssf_memchr_find(
            hay.data_ptr(), lim, int(byte) & 0xFF, base, span, n_spans,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(err, "ssf_memchr_find")
    tracing.count("launches.memchr_find")
    return out[0]

