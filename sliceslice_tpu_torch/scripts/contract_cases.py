"""The probe-table contract cases, as seeded haystacks and tables.

The JAX package's TPU kernels compare a table's non-final slots without
their masks, so its ``*_cols`` entry points refuse a table whose narrower
rows have mask-0 slots below the last (``probe table violates width
contract``).  The port's find, count and match-bitmap kernels apply every
slot's mask and take a mask-0 slot as true, so any table of masked slots
gets the exact answer.  One list of cases serves the CPU tests (the plain
versions, beside the JAX package), the card tests and the smoke run (each
kernel against its plain version), all against host oracles:

* ``mixed_width``: ``build_probe_table([b"abcd", b"0123456789abcdef"])``
  (t = 4; the first row's slots 1..3 have mask 0) over ``b"xxxxabcdyyyy"``,
  20,000 zero bytes, the 16-byte needle and 100 zero bytes: the table
  the JAX package's contract test refuses;
* ``exotic_mask``: a caller-built t = 2 row whose final mask,
  ``0xFFFF0000``, is not a byte prefix (it matches ``b"QRST??WX"``), over
  300,000 seeded bytes with ``b"QRSTUVWX"`` planted at 123,456;
* ``prefix_mask``: ``build_probe_table([b"QRSTUVW"])`` over the same bytes.

:func:`answers` runs the find, count, bitmap and compaction wrappers (or
their plain versions) on one case; :func:`oracle` gives ``bytes.find``'s
first offsets, ``overlapping_count``'s counts and the host scan's
positions, or, for the caller-built row, those of a regular expression.
"""

from __future__ import annotations

import re
import struct
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..needle import build_probe_table, needed_halo_for_t
from ..ops import scan_kernel
from ..ops.layout import preprocess
from ..ops.scan_math import table_bits
from ..searcher import _host_positions, overlapping_count

#: The compaction's cap: above every case's count, so it lists every match.
CAP = 64
#: Where ``exotic_mask`` and ``prefix_mask`` plant ``b"QRSTUVWX"``.
EXOTIC_AT = 123_456


class ContractCase(NamedTuple):
    name: str
    hay: bytes
    values: np.ndarray  # uint32 [N, t]
    masks: np.ndarray  # uint32 [N, t]
    ends: np.ndarray  # int32 [N]
    needles: Optional[list]  # the rows' needles, when the table was built from them
    pattern: Optional[bytes] = None  # else a regular expression of what each row matches


def _ends(hay: bytes, lengths) -> np.ndarray:
    return np.maximum(len(hay) - np.asarray(lengths, np.int64) + 1, 0).astype(np.int32)


def cases() -> list:
    mixed_hay = b"xxxxabcdyyyy" + bytes(20_000) + b"0123456789abcdef" + bytes(100)
    mixed = [b"abcd", b"0123456789abcdef"]
    values, masks, lengths = build_probe_table(mixed)
    out = [ContractCase("mixed_width", mixed_hay, values, masks, _ends(mixed_hay, lengths), mixed)]

    rng = np.random.default_rng(17)
    hay = bytearray(rng.integers(97, 105, (300_000,), dtype=np.uint8))
    hay[EXOTIC_AT:EXOTIC_AT + 8] = b"QRSTUVWX"
    hay = bytes(hay)
    v0, v1 = struct.unpack("<2I", b"QRSTUVWX")
    exotic = (np.array([[v0, v1 & 0xFFFF0000]], np.uint32),
              np.array([[0xFFFFFFFF, 0xFFFF0000]], np.uint32))
    out.append(ContractCase("exotic_mask", hay, *exotic, _ends(hay, [8]), None, rb"QRST..WX"))
    values, masks, lengths = build_probe_table([b"QRSTUVW"])
    out.append(ContractCase("prefix_mask", hay, values, masks, _ends(hay, lengths), [b"QRSTUVW"]))
    return out


def operands(case: ContractCase, device):
    """``(dh, values, masks, ends)``: the case's haystack laid out on
    ``device`` and its tables as int32 tensors there (values re-masked, as
    the wrappers re-mask numpy tables)."""
    dh = preprocess(case.hay, kh=needed_halo_for_t(case.values.shape[1]), device=device)
    v = table_bits(case.values & case.masks, dh.device)
    m = table_bits(case.masks, dh.device)
    e = torch.from_numpy(case.ends).to(dh.device)
    return dh, v, m, e


def answers(flat, v, m, e, plain: bool = False) -> tuple:
    """``(firsts, counts, positions)`` of one table over ``flat``: first
    offsets (-1 when absent), overlapping counts and every match offset
    (int64 arrays), from the find, count, match-bitmap and compaction
    wrappers, or from their plain versions when ``plain``."""
    sk = scan_kernel
    find = sk.batched_find_plain if plain else sk.batched_find
    count = sk.batched_count_plain if plain else sk.batched_count
    bitmap = sk.match_bitmap_counted_plain if plain else sk.match_bitmap_counted
    compact = sk.compact_positions_plain if plain else sk.compact_positions
    firsts = [-1 if f >= sk.SENTINEL else f for f in find(flat, v, m, e).tolist()]
    counts = count(flat, v, m, e).tolist()
    totals, offsets = compact(*bitmap(flat, v, m, e), CAP)
    offsets = offsets.cpu().numpy()
    positions = [offsets[i, :c].astype(np.int64) for i, c in enumerate(totals.tolist())]
    return firsts, counts, positions


def oracle(case: ContractCase) -> tuple:
    """The host's ``(firsts, counts, positions)`` for the case's rows."""
    if case.needles is not None:
        pos = [_host_positions(case.hay, nd) for nd in case.needles]
        counts = [overlapping_count(case.hay, nd) for nd in case.needles]
        firsts = [case.hay.find(nd) for nd in case.needles]
    else:
        hits = [m.start() for m in re.finditer(b"(?=" + case.pattern + b")", case.hay, re.DOTALL)]
        pos = [np.asarray(hits, np.int64)]
        counts = [len(hits)]
        firsts = [hits[0] if hits else -1]
    return firsts, counts, pos


def same(a: tuple, b: tuple) -> bool:
    """Two ``(firsts, counts, positions)`` triples are equal."""
    return (list(a[0]) == list(b[0]) and list(a[1]) == list(b[1]) and len(a[2]) == len(b[2])
            and all(np.array_equal(x, y) for x, y in zip(a[2], b[2])))
