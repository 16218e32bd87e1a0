"""Kernel wrappers of the find, count and positions paths:
``batched_find``, ``batched_count``, ``match_bitmap`` and ``memchr_find``.

Each wrapper launches its hand-written CUDA kernel (``csrc/find.cu``) for a
haystack on a CUDA device and runs its plain PyTorch version, defined
beside it with the same signature, for a haystack on the CPU.  Any other
device raises; nothing falls back from the card to the CPU.  Each wrapper
counts its kernel launches in a plain integer attribute, ``launches``.

``batched_find`` replaces ``sliceslice_tpu/ops/scan_kernel.py``'s
``batched_find_cols`` over the Pallas find kernel, ``batched_count`` its
``batched_count_cols`` over the Pallas count kernel, ``memchr_find`` its
``memchr_find_cols``, and ``match_bitmap`` the plain-XLA
``xla_backend.match_bitmap_batched`` of the positions path (linear here).
The haystack is the flat layout of :mod:`.layout`: positions are byte
offsets into it, and its zero halo must cover
``needed_halo_for_t(t)`` bytes past the last valid position.  Positions
whose probe windows would run past the buffer are never evaluated, by
either version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import config
from ..config import SENTINEL
from . import cuda_lib
from .scan_math import first_offsets, match_bits, match_counts, position_limit, table_bits

#: Probe-table widths up to this are exact width groups in
#: ``BatchedSearcher``; wider tables are bucketed (the JAX unroll limit).
PROBE_UNROLL = 8
#: Widest probe table the find and count kernels take (``MAX_NEEDLE_LEN / 4``).
MAX_T = 512

#: Positions the find and count kernels evaluate per block step, bytes
#: the memchr kernel reads per block step (csrc/find.cu kFindTile /
#: kMemchrTile).
FIND_TILE = 1024
MEMCHR_TILE = 4096
#: Least positions one block owns: below this, extra blocks cost more to
#: schedule than the parallelism they add.
MIN_SPAN = 1 << 16
#: Resident blocks per SM times waves: the grid the span plan aims for.
BLOCKS_PER_SM = 16


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


def _launch(entry: str, hay, values, masks, ends, out, base: int, n_real: int, *extra) -> bool:
    """One launch of the find, count or bitmap kernel (``entry``) over rows
    below ``n_real``, writing into ``out``, with the entry's ``extra``
    arguments before the stream; False when there is nothing to scan."""
    values, masks, ends = values.contiguous(), masks.contiguous(), ends.contiguous()
    _cuda_ready(hay, values, masks, ends)
    t = values.shape[1]
    n_pos = position_limit(hay.numel(), t)
    if n_real == 0 or n_pos == 0:
        return False
    lib = cuda_lib.load()
    with torch.cuda.device(hay.device):
        span, n_spans = plan_spans(n_pos, n_real, FIND_TILE, _sm_count(torch.cuda.current_device()))
        err = getattr(lib, entry)(
            hay.data_ptr(), n_pos, values.data_ptr(), masks.data_ptr(),
            ends.data_ptr(), out.data_ptr(), n_real, t, base, span, n_spans, *extra,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(err, entry)
    return True


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


def batched_find(hay, values, masks, ends, base=0, n_real=None) -> torch.Tensor:
    """First-match offsets (int32[N], SENTINEL when absent) of N probe
    programs over the flat haystack ``hay``.

    Row ``n < n_real`` reports the smallest ``p`` with ``p + base <
    ends[n]`` at which every slot ``i`` satisfies ``(window(p + 4i) &
    masks[n, i]) == values[n, i]``, as ``p + base``; rows at or past
    ``n_real`` are never scanned and report SENTINEL.  ``values``/``masks``
    are uint32 numpy tables (re-masked here, as the JAX wrapper does) or
    int32 bit-pattern tensors; ``ends`` are int32, in the same frame as the
    reported offsets.  Padded rows (mask 0, end 0) report SENTINEL."""
    base, values, masks, ends = _operands(hay, values, masks, ends, base)
    device = hay.device
    if device.type == "cpu":
        return batched_find_plain(hay, values, masks, ends, base, n_real)
    if device.type != "cuda":
        raise ValueError(f"no find kernel for device {device}")
    n = values.shape[0]
    out = torch.full((n,), SENTINEL, dtype=torch.int32, device=device)
    if _launch("ssf_batched_find", hay, values, masks, ends, out, base, _n_real(n_real, n)):
        batched_find.launches += 1
    return out


batched_find.launches = 0


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


def batched_count(hay, values, masks, ends, base=0, n_real=None) -> torch.Tensor:
    """Overlapping match counts (int32[N]) of N probe programs over the
    flat haystack ``hay``, with the operands of :func:`batched_find`.

    Row ``n < n_real`` reports how many positions ``p`` with ``p + base <
    ends[n]`` satisfy every slot; the counts do not depend on ``base``
    otherwise.  Rows at or past ``n_real`` are never scanned and report 0,
    as do padded rows (mask 0, end 0).  ``ends`` must exclude positions
    past ``length - k + 1``: a needle ending in zero bytes also matches in
    the layout's zero halo."""
    base, values, masks, ends = _operands(hay, values, masks, ends, base)
    device = hay.device
    if device.type == "cpu":
        return batched_count_plain(hay, values, masks, ends, base, n_real)
    if device.type != "cuda":
        raise ValueError(f"no count kernel for device {device}")
    n = values.shape[0]
    out = torch.zeros((n,), dtype=torch.int32, device=device)
    if _launch("ssf_batched_count", hay, values, masks, ends, out, base, _n_real(n_real, n)):
        batched_count.launches += 1
    return out


batched_count.launches = 0


def bitmap_words(nbytes: int, t: int) -> int:
    """Words per row of :func:`match_bitmap`'s output over an ``nbytes``
    haystack and width-``t`` tables: one bit per evaluated position."""
    return -(-position_limit(nbytes, t) // 32)


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
    exclude positions past ``length - k + 1``."""
    base, values, masks, ends = _operands(hay, values, masks, ends, base)
    device = hay.device
    if device.type == "cpu":
        return match_bitmap_plain(hay, values, masks, ends, base, n_real)
    if device.type != "cuda":
        raise ValueError(f"no match-bitmap kernel for device {device}")
    n, t = values.shape
    words = bitmap_words(hay.numel(), t)
    out = torch.zeros((n, words), dtype=torch.int32, device=device)
    if _launch("ssf_match_bitmap", hay, values, masks, ends, out, base, _n_real(n_real, n), words):
        match_bitmap.launches += 1
    return out


match_bitmap.launches = 0


def memchr_find_plain(hay, byte, end, base=0) -> torch.Tensor:
    """Plain PyTorch version of :func:`memchr_find`."""
    lim = min(int(end) - base, hay.numel())
    if lim <= 0:
        return torch.tensor(SENTINEL, dtype=torch.int32, device=hay.device)
    hit = hay[:lim] == (int(byte) & 0xFF)
    first = hit.to(torch.uint8).argmax().to(torch.int64)
    return torch.where(hit.any(), first + base, SENTINEL).to(torch.int32)


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
    memchr_find.launches += 1
    return out[0]


memchr_find.launches = 0
