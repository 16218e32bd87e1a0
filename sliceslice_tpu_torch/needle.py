"""Needle abstraction and probe compilation (numpy only).

A line-for-line port of ``sliceslice_tpu/needle.py``: the tables it builds
are byte-identical to the JAX package's, so both packages can be held
against each other on the same inputs.

A :class:`Needle` carries its bytes plus a *probe program* — a static list
of packed little-endian ``uint32`` window compares that together prove an
exact match.  A needle of length ``k`` compiles to ``ceil(k / 4)`` probes:

* full 4-byte windows at static offsets ``0, 4, 8, …`` and, when
  ``k % 4 != 0``, a final probe at offset ``4*(t-1)`` whose mask narrows to
  the remaining ``k % 4`` bytes (offsets stay static per slot — no
  overlapping window, see :func:`probe_program`), or
* for ``k < 4``, a single masked probe at offset 0 covering ``k`` bytes.

``match[i] == AND_t (window32(hay, i + off_t) & mask_t) == value_t``
(values are pre-masked, so the 2-op form is exact)

where ``window32(hay, p) = hay[p] | hay[p+1]<<8 | hay[p+2]<<16 | hay[p+3]<<24``.

``position`` is kept for API parity with ``with_position`` (reference:
src/x86.rs:252-255, a DoS-hardening knob choosing the second filter byte).
The device kernels IGNORE it: every position costs at most ``ceil(k/4)``
probe compares whatever the input, so the adversarial-input slowdown the
knob mitigates (a pathological candidate filter feeding a serial verify
loop) cannot occur — results are identical for every valid ``position``.
The value is validated against the reference contract (``0 <= position <
k``, src/x86.rs:300) and recorded on the :class:`Needle`; the only
execution path that consults it is the host SWAR rung for tiny haystacks
(csrc/swarscan.cpp ``swar_find_pos``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import numpy as np

NeedleLike = Union[bytes, bytearray, memoryview, np.ndarray, str]

#: Longest needle supported by the probe kernels.  Covers the random
#: benchmark's largest needle (bench/benches/random.rs:16 uses 1000 bytes)
#: with 2x headroom; the same bound as the JAX package, so both accept and
#: refuse the same needles.
MAX_NEEDLE_LEN = 2048


def as_bytes(needle: NeedleLike) -> bytes:
    """Normalize any accepted needle type to ``bytes`` (reference: the
    ``Needle`` impls for arrays/slices/Box/Rc/Arc/Vec, src/lib.rs:43-104)."""
    if isinstance(needle, str):
        return needle.encode("utf-8")
    if isinstance(needle, (bytes, bytearray)):
        return bytes(needle)
    if isinstance(needle, memoryview):
        return needle.tobytes()
    if isinstance(needle, np.ndarray):
        if needle.dtype != np.uint8:
            raise TypeError(f"needle ndarray must be uint8, got {needle.dtype}")
        return needle.tobytes()
    raise TypeError(f"unsupported needle type: {type(needle)!r}")


def pack_le32(b: bytes) -> int:
    """Little-endian pack of up to 4 bytes into a uint32."""
    v = 0
    for i, byte in enumerate(b[:4]):
        v |= byte << (8 * i)
    return v


def probe_program(needle: bytes) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Compile a needle into (values, masks) uint32 probe tuples.

    Probe slot ``t`` always compares the 4-byte window at offset ``4*t`` —
    offsets are *implicit and static per slot*, with no per-needle offset
    table.  The final probe of a needle whose length is not a multiple of 4
    is mask-narrowed to its ``k % 4`` bytes instead of overlapping at
    ``k - 4``.

    Invariant: a position ``i`` satisfies all probes iff
    ``hay[i : i + len(needle)] == needle`` (given windows never read past the
    buffer, which layout padding guarantees; correctness then only requires
    masking positions to ``i <= len(hay) - len(needle)``).
    """
    k = len(needle)
    if k == 0:
        return (), ()
    values = []
    masks = []
    for t in range(num_probes(k)):
        chunk = needle[4 * t : 4 * t + 4]
        values.append(pack_le32(chunk))
        masks.append((1 << (8 * len(chunk))) - 1)
    return tuple(values), tuple(masks)


def num_probes(k: int) -> int:
    """Number of uint32 probes for a needle of length k (= ceil(k/4), min 1)."""
    if k <= 0:
        return 0
    return max(1, -(-k // 4))


def needed_halo_for_t(t: int) -> int:
    """Halo bytes a layout must carry for width-``t`` probe tables: the last
    probe slot reads packed windows up to row 4*(t-1), whose window spans 3
    further bytes.  The single source of the width->halo formula (shared by
    the batched/streaming layout planners and the kernel asserts)."""
    return max(4 * t - 1, 3)


def needed_halo(k: int) -> int:
    """Halo bytes for needles of length k.  T is rounded up to even beyond
    8, as in the JAX package (whose pair-looped long-needle path appends a
    no-op slot), so both packages size halos alike."""
    if k <= 0:
        return 3
    t = num_probes(k)
    if t > 8 and t % 2:
        t += 1
    return needed_halo_for_t(t)


@dataclasses.dataclass(frozen=True)
class Needle:
    """A preprocessed needle: bytes + probe program + filter position.

    Mirrors the reference searchers' stored state (needle bytes + the two
    splatted hash registers, src/lib.rs:161-188) — preprocessing is O(k), done
    once, and reused across any number of searches.
    """

    data: bytes
    position: int  # index of the secondary filter byte; default k-1

    def __init__(self, needle: NeedleLike, position: int | None = None):
        data = as_bytes(needle)
        k = len(data)
        if position is None:
            # Reference ``new`` uses size-1 (src/x86.rs:281-287); for the
            # empty needle this wraps and the position assert fires below —
            # we surface the same contract as an explicit error.
            position = k - 1
        if not (0 <= position < k):
            raise ValueError(
                f"invalid position {position} for needle of length {k} "
                "(reference contract: position < needle.size(), src/x86.rs:300)"
            )
        if k > MAX_NEEDLE_LEN:
            raise ValueError(f"needle longer than MAX_NEEDLE_LEN={MAX_NEEDLE_LEN}")
        object.__setattr__(self, "data", data)
        object.__setattr__(self, "position", position)

    @property
    def size(self) -> int:
        return len(self.data)

    @property
    def probes(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        return probe_program(self.data)

    def as_array(self) -> np.ndarray:
        return np.frombuffer(self.data, dtype=np.uint8)


def build_probe_table(
    needles: Sequence[bytes], t_max: int | None = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batch many needles into dense probe tables for the batched kernels.

    Returns ``(values[N, T], masks[N, T], lengths[N])``; slot ``t`` compares
    the window at static offset ``4*t``.  Inactive probe slots have
    ``mask == 0`` (and value 0), which makes the probe trivially true — so a
    single fixed-T kernel evaluates needles of mixed lengths exactly.  This
    is the batched generalization of the reference's per-length
    specialization family (src/x86.rs:397-526): instead of 17 enum arms there
    is one dense table whose rows *are* the specializations.
    """
    n = len(needles)
    lengths = np.fromiter((len(nd) for nd in needles), np.int32, count=n)
    if t_max is None:
        t_max = max((num_probes(len(nd)) for nd in needles), default=1)
    t_max = max(t_max, 1)
    if n and int(lengths.max()) > 4 * t_max:
        bad = int(np.argmax(lengths))
        raise ValueError(
            f"needle {bad} needs {num_probes(int(lengths[bad]))} probes "
            f"> t_max={t_max}"
        )
    # Vectorized packing: one row-copy per needle (C memcpy), then a
    # little-endian uint32 view IS the value table; masks derive from
    # lengths alone.  ~10x faster than per-needle probe_program calls —
    # table construction is the host cost of a fresh query batch.
    raw = np.zeros((n, 4 * t_max), dtype=np.uint8)
    for i, nd in enumerate(needles):
        raw[i, : len(nd)] = np.frombuffer(bytes(nd), dtype=np.uint8)
    values = raw.view("<u4").copy()
    slot = np.arange(t_max, dtype=np.int32)[None, :]
    full = slot < (lengths // 4)[:, None]
    rem = (lengths % 4)[:, None]
    partial = (slot == (lengths // 4)[:, None]) & (rem > 0)
    masks = np.where(
        full,
        np.uint32(0xFFFFFFFF),
        np.where(partial, (np.uint32(1) << (8 * rem).astype(np.uint32)) - 1, 0),
    ).astype(np.uint32)
    values &= masks  # padded bytes beyond each needle are already 0; keep
    # values consistent with masks regardless.
    return values, masks, lengths
