"""The plain reference: CPython's ``bytes.find`` and NumPy, worked out from
the generated inputs alone.  It imports nothing of the program.

- ``find``: each needle's first offset, -1 where absent;
- ``count``: each needle's overlapping occurrences;
- ``positions``: each needle's every overlapping offset, ascending.

An empty needle matches at every offset, the end included.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def positions(hay: bytes, needle: bytes) -> np.ndarray:
    if not needle:
        return np.arange(len(hay) + 1, dtype=np.int64)
    out, p = [], hay.find(needle)
    while p != -1:
        out.append(p)
        p = hay.find(needle, p + 1)
    return np.asarray(out, dtype=np.int64)


def find_all(hay: bytes, needles: Sequence[bytes]) -> np.ndarray:
    return np.array([hay.find(n) for n in needles], dtype=np.int64)


def count_all(hay: bytes, needles: Sequence[bytes]) -> np.ndarray:
    return np.array([positions(hay, n).size for n in needles], dtype=np.int64)


def positions_all(hay: bytes, needles: Sequence[bytes]) -> List[np.ndarray]:
    return [positions(hay, n) for n in needles]


ANSWERS = {"find": find_all, "count": count_all, "positions": positions_all}


def answers(op: str, hay: bytes, needles: Sequence[bytes]):
    return ANSWERS[op](hay, needles)


def wrong_answers(op: str, got, want) -> int:
    """How many needles' answers in ``got`` differ from ``want``; all of
    them when ``got`` does not hold one answer per needle."""
    n = len(want)
    if op == "positions":
        if len(got) != n:
            return n
        return sum(not np.array_equal(np.asarray(g), w) for g, w in zip(got, want))
    got = np.asarray(got)
    if got.shape != want.shape:
        return n
    return int(np.count_nonzero(got.astype(np.int64) != want))
