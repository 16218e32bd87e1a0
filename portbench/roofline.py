"""The least time one card could take for the work a request needs.

Peaks: NVIDIA's data sheet and Hopper white paper for the H100 SXM (80 GB
HBM3), at its full 700 W power limit, as ``sliceslice_tpu_torch/utils/
profiling.py`` (``HBM_ROOFLINE``, ``INT32_PEAK``, ``bound_ms``) states
them; report the card's power limit beside any share of them.

Recounted here: a position tested for one needle costs a quarter of a
32-bit integer operation (four byte lanes in one op), so that no kernel
can read above 100% by testing four positions per op.  Positions are
those the inputs need tested: for a first offset, each needle's positions
up to and including its first match, or all ``len - k + 1`` when it is
absent; for counts and the match bitmap, all ``len - k + 1``.  Bytes are
each input read once and each output written once.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

#: 32-bit integer operations per second: 132 SMs x 64 INT32 lanes x 1.98 GHz.
INT32_PEAK = 132 * 64 * 1.98e9
#: HBM bytes per second.
HBM_BYTES_PER_S = 3.35e12
#: Positions one 32-bit operation can test.
POSITIONS_PER_OP = 4


def bound_s(positions: float, nbytes: float) -> float:
    """The larger of the operations' and the bytes' least time, seconds."""
    return max(positions / POSITIONS_PER_OP / INT32_PEAK, nbytes / HBM_BYTES_PER_S)


def scan_positions(hay_len: int, lengths: Sequence[int]) -> int:
    k = np.asarray(lengths, np.int64)
    return int(np.maximum(hay_len - k + 1, 0).sum())


def find_positions(hay_len: int, lengths: Sequence[int], firsts: Sequence[int]) -> int:
    k = np.asarray(lengths, np.int64)
    f = np.asarray(firsts, np.int64)
    return int(np.where(f >= 0, f + 1, np.maximum(hay_len - k + 1, 0)).sum())


def find_s(hay_len: int, lengths: Sequence[int], firsts: Sequence[int]) -> float:
    """First offsets: corpus and needles in, one int32 per needle out."""
    nbytes = hay_len + int(np.sum(lengths)) + 4 * len(lengths)
    return bound_s(find_positions(hay_len, lengths, firsts), nbytes)


def count_s(hay_len: int, lengths: Sequence[int]) -> float:
    """Counts: corpus and needles in, one int32 per needle out."""
    nbytes = hay_len + int(np.sum(lengths)) + 4 * len(lengths)
    return bound_s(scan_positions(hay_len, lengths), nbytes)


def bitmap_s(hay_len: int, lengths: Sequence[int]) -> float:
    """The match bitmap: corpus and needles in, one bit per position out."""
    pos = scan_positions(hay_len, lengths)
    return bound_s(pos, hay_len + int(np.sum(lengths)) + pos / 8)
