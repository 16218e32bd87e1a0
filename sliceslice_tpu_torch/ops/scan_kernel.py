"""Kernel wrappers of the find path: ``batched_find`` and ``memchr_find``.

Each wrapper launches its hand-written CUDA kernel (``csrc/find.cu``) for a
haystack on a CUDA device and runs its plain PyTorch version, defined
beside it with the same signature, for a haystack on the CPU.  Any other
device raises; nothing falls back from the card to the CPU.  Each wrapper
counts its kernel launches in a plain integer attribute, ``launches``.

``batched_find`` replaces ``sliceslice_tpu/ops/scan_kernel.py``'s
``batched_find_cols`` over the Pallas find kernel, ``memchr_find`` its
``memchr_find_cols``.  The haystack is the flat layout of
:mod:`.layout`: positions are byte offsets into it, and its zero halo
must cover ``needed_halo_for_t(t)`` bytes past the last valid position.
Positions whose probe windows would run past the buffer are never
evaluated, by either version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import config
from ..config import SENTINEL
from . import cuda_lib
from .scan_math import first_offsets, position_limit, table_bits

#: Probe-table widths up to this are exact width groups in
#: ``BatchedSearcher``; wider tables are bucketed (the JAX unroll limit).
PROBE_UNROLL = 8
#: Widest probe table the find kernel takes (``MAX_NEEDLE_LEN / 4``).
MAX_T = 512

#: Positions the find kernel evaluates per block step, bytes the memchr
#: kernel reads per block step (csrc/find.cu kFindTile / kMemchrTile).
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


def batched_find_plain(hay, values, masks, ends, base=0, n_real=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`batched_find` (same signature and
    answers; tables as int32 bit-pattern tensors on ``hay``'s device)."""
    n, t = values.shape
    n_real = n if n_real is None else max(0, min(int(n_real), n))
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
    if device.type == "cpu":
        return batched_find_plain(hay, values, masks, ends, base, n_real)
    if device.type != "cuda":
        raise ValueError(f"no find kernel for device {device}")
    n_real = n if n_real is None else max(0, min(int(n_real), n))
    values, masks, ends = values.contiguous(), masks.contiguous(), ends.contiguous()
    _cuda_ready(hay, values, masks, ends)
    out = torch.full((n,), SENTINEL, dtype=torch.int32, device=device)
    n_pos = position_limit(hay.numel(), t)
    if n_real == 0 or n_pos == 0:
        return out
    lib = cuda_lib.load()
    with torch.cuda.device(device):
        span, n_spans = plan_spans(n_pos, n_real, FIND_TILE, _sm_count(torch.cuda.current_device()))
        err = lib.ssf_batched_find(
            hay.data_ptr(), n_pos, values.data_ptr(), masks.data_ptr(),
            ends.data_ptr(), out.data_ptr(), n_real, t, base, span, n_spans,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(err, "ssf_batched_find")
    batched_find.launches += 1
    return out


batched_find.launches = 0


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
