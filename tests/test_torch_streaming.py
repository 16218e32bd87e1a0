"""Streams of any length in the port against the JAX package and the host
oracles — the mirror of tests/test_streaming.py case by case (its two mesh
cases on a mesh of cells on the CPU and the JAX package's virtual mesh), of
tests/test_utils.py's offsets past 2^32 and of tests/test_fuzz.py's window
geometry fuzz.  Each case runs the port's ``StreamingScanner`` on the CPU
(the kernels' plain versions, every window in the one layout) and the
JAX ``StreamingScanner`` as its own tests run it, on the same inputs, and
holds both to ``bytes.find``, ``overlapping_count`` and the host positions
scan.  Then the port's int64 device folds against the JAX two-limb and
lexicographic folds, and the port's own contracts: no
window buffer is allocated after ``warmup``, no ingest thread outlives a
stream, and every window lies in the pooled layout.  Every comparison is
exact."""

import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st_

import sliceslice_tpu.utils.streaming as jstreaming
import sliceslice_tpu_torch.utils.streaming as tstreaming
from sliceslice_tpu_torch import StreamingScanner
from sliceslice_tpu_torch.config import SENTINEL
from sliceslice_tpu_torch.needle import MAX_NEEDLE_LEN
from sliceslice_tpu_torch.ops.layout import SHORT_HAY_BYTES, padded_total
from sliceslice_tpu_torch.parallel.shard_scan import shard_bytes_for
from sliceslice_tpu_torch.searcher import _host_positions, overlapping_count

#: The CPU tests run the kernels' plain versions: the port's entry points
#: take the card unless asked for the CPU.
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(42)
    return bytes(rng.integers(97, 103, (1_000_000,), dtype=np.uint8))


def scanners(needles, **kw):
    """The port's scanner (on the CPU) and the JAX package's, alike."""
    return StreamingScanner(needles, device=CPU, **kw), jstreaming.StreamingScanner(needles, **kw)


def firsts(data: bytes, needles, start: int = 0):
    return [(data.find(nd) + start if data.find(nd) >= 0 else -1) for nd in needles]


def same_positions(got, exp) -> bool:
    return len(got) == len(exp) and all(
        g.dtype == np.int64 and np.array_equal(g, e) for g, e in zip(got, exp)
    )


def held(port, jax, call, exp):
    """``call(scanner)`` of both scanners, each equal to ``exp`` (int64
    arrays for find and count, lists of them for positions)."""
    got, ref = call(port), call(jax)
    if isinstance(exp, list) and exp and isinstance(exp[0], np.ndarray):
        assert same_positions(got, exp) and same_positions(ref, exp)
    else:
        assert got.dtype == np.int64
        assert list(got) == list(exp) and list(ref) == list(exp)
    return got


def host_positions(data, needles, start: int = 0):
    return [_host_positions(data, nd) + start for nd in needles]


def counts(data, needles):
    return [overlapping_count(data, nd) for nd in needles]


def test_stream_file(tmp_path, corpus):
    p = tmp_path / "c.bin"
    p.write_bytes(corpus)
    needles = [corpus[0:5], corpus[450_000:450_012], corpus[999_990:1_000_000], b"XYZQ", corpus[-3:]]
    port, jax = scanners(needles, window_bytes=200_000)  # 5 windows
    held(port, jax, lambda s: s.find_in_file(str(p), early_stop=False), firsts(corpus, needles))


def test_stream_window_boundary(tmp_path, corpus):
    win = 131_072
    p = tmp_path / "c.bin"
    p.write_bytes(corpus)
    needles = [corpus[win - 6 : win + 6], corpus[2 * win - 3 : 2 * win + 9]]
    port, jax = scanners(needles, window_bytes=win)
    held(port, jax, lambda s: s.find_in_file(str(p), early_stop=False), firsts(corpus, needles))


def test_stream_chunks_equal_file(tmp_path, corpus):
    needles = [corpus[123_456:123_470], b"NOPE!"]
    port, jax = scanners(needles, window_bytes=150_000)
    p = tmp_path / "c.bin"
    p.write_bytes(corpus)

    def chunks():
        for i in range(0, len(corpus), 37_111):  # awkward chunk size
            yield corpus[i : i + 37_111]

    exp = firsts(corpus, needles)
    held(port, jax, lambda s: s.find_in_chunks(chunks(), early_stop=False), exp)
    assert list(port.find_in_file(str(p), early_stop=False)) == exp


def test_stream_early_stop(tmp_path, corpus):
    p = tmp_path / "c.bin"
    p.write_bytes(corpus)
    needles = [corpus[10:20], corpus[50:58]]  # all found in window 0
    port, jax = scanners(needles, window_bytes=100_000, check_every=1)
    held(port, jax, lambda s: s.find_in_file(str(p), early_stop=True), firsts(corpus, needles))
    assert port.stats["windows"] == 1  # stopped after the first window


def test_stream_count(tmp_path, corpus):
    """Streaming overlapping counts: exact across window boundaries."""
    p = tmp_path / "c.bin"
    p.write_bytes(corpus)
    win = 131_072
    needles = [
        corpus[0:3],                      # frequent
        corpus[win - 4 : win + 4],        # straddles a window boundary
        b"NOPE!",
        corpus[-5:],
        b"a",                             # 1-byte, very frequent
    ]
    port, jax = scanners(needles, window_bytes=win)
    held(port, jax, lambda s: s.count_in_file(str(p)), counts(corpus, needles))


def test_stream_count_periodic_overlap(tmp_path):
    """Overlapping occurrences inside AND across windows count exactly."""
    blob = b"abab" * 40_000  # 160 KB of overlapping 'abab's
    p = tmp_path / "p.bin"
    p.write_bytes(blob)
    needles = [b"abab", b"baba"]
    port, jax = scanners(needles, window_bytes=65_536)
    held(port, jax, lambda s: s.count_in_file(str(p)), counts(blob, needles))


def test_stream_first_occurrence_dedup(tmp_path):
    # A needle present in several windows reports its FIRST occurrence.
    blob = (b"marker" + bytes(100_000)) * 3
    p = tmp_path / "c.bin"
    p.write_bytes(blob)
    needles = [b"marker", bytes(8)]
    port, jax = scanners(needles, window_bytes=65_536)
    got = held(port, jax, lambda s: s.find_in_file(str(p), early_stop=False), firsts(blob, needles))
    assert got[0] == 0


def test_stream_positions(tmp_path, corpus):
    """Every offset, exactly once, across several windows, including
    window-straddling matches."""
    win = 131_072
    p = tmp_path / "c.bin"
    p.write_bytes(corpus)
    needles = [
        corpus[0:3],                      # frequent
        corpus[win - 4 : win + 4],        # straddles a window boundary
        corpus[2 * win - 3 : 2 * win + 9],
        b"NOPE!",
        corpus[-5:],
    ]
    port, jax = scanners(needles, window_bytes=win)
    held(port, jax, lambda s: s.positions_in_file(str(p)), host_positions(corpus, needles))


def test_stream_positions_chunks_equal_file(corpus):
    needles = [corpus[123_456:123_470], corpus[0:4]]
    port, jax = scanners(needles, window_bytes=150_000)

    def chunks():
        for i in range(0, len(corpus), 41_113):
            yield corpus[i : i + 41_113]

    held(port, jax, lambda s: s.positions_in_chunks(chunks()), host_positions(corpus, needles))


def test_stream_start_offset_past_2_32(corpus):
    """int64 offsets past 2^32 through the public path: a chunk stream
    declared to start just below 2^32, so window bases cross it
    mid-stream."""
    data = corpus[:400_000]
    win = 65_536
    start = 2**32 - 2 * win - 777  # bases cross 2^32 at the third window
    needles = [
        data[3 * win - 5 : 3 * win + 7],  # found after the 2^32 crossing
        data[10:22],                      # found before it
        b"NOPE!",
    ]
    port, jax = scanners(needles, window_bytes=win)

    def chunks():
        for i in range(0, len(data), 50_021):
            yield data[i : i + 50_021]

    got = held(port, jax, lambda s: s.find_in_chunks(chunks(), early_stop=False, start_offset=start),
               firsts(data, needles, start))
    assert got[0] > 2**32  # the point of the test
    held(port, jax, lambda s: s.positions_in_chunks(chunks(), start_offset=start),
         host_positions(data, needles, start))


def test_stream_file_start_offset(tmp_path, corpus):
    """find_in_file(start_offset=X) scans the file tail; offsets stay
    absolute file offsets."""
    p = tmp_path / "c.bin"
    p.write_bytes(corpus)
    start = 500_000
    tail = corpus[start:]
    needles = [corpus[10:30], tail[1_000:1_012], tail[-6:]]
    port, jax = scanners(needles, window_bytes=100_000)
    held(port, jax, lambda s: s.find_in_file(str(p), early_stop=False, start_offset=start),
         firsts(tail, needles, start))
    assert list(port.count_in_file(str(p), start_offset=start)) == counts(tail, needles)


def test_stream_huge_needles(tmp_path, corpus):
    """Needles beyond MAX_NEEDLE_LEN stream exactly (filter and verify
    against each window's host bytes), including a window-boundary
    straddle."""
    win = 131_072
    k = MAX_NEEDLE_LEN + 1000
    needles = [
        corpus[win - 1500 : win - 1500 + k],   # straddles window boundary
        corpus[300_000 : 300_000 + k],
        corpus[0:5],                           # mixed with a kernel needle
        corpus[: k + 7],                       # huge at offset 0
        bytes(k),                              # absent huge
    ]
    p = tmp_path / "c.bin"
    p.write_bytes(corpus)
    port, jax = scanners(needles, window_bytes=win)
    assert port.overlap == jax.overlap == k + 6  # covers the longest (huge) needle
    held(port, jax, lambda s: s.find_in_file(str(p), early_stop=False), firsts(corpus, needles))
    held(port, jax, lambda s: s.count_in_file(str(p)), counts(corpus, needles))
    held(port, jax, lambda s: s.positions_in_file(str(p)), host_positions(corpus, needles))


def test_stream_huge_periodic_across_windows(tmp_path):
    """A periodic huge needle with overlapping occurrences that span
    window boundaries counts each occurrence exactly once."""
    unit = b"xy"
    k = MAX_NEEDLE_LEN + 2  # even
    nd = unit * (k // 2)
    blob = unit * 40_000 + b"Z" + unit * 3_000  # 86 KB, dense overlaps
    p = tmp_path / "p.bin"
    p.write_bytes(blob)
    port, jax = scanners([nd], window_bytes=16_384)
    held(port, jax, lambda s: s.count_in_file(str(p)), counts(blob, [nd]))
    held(port, jax, lambda s: s.positions_in_file(str(p)), host_positions(blob, [nd]))


def test_stream_huge_match_past_window_in_final_window():
    """A chunk stream shorter than window + overlap arrives as ONE final
    window longer than ``window``; the huge needles' bound must use the
    stream's true end there."""
    rng = np.random.default_rng(7)
    hay = bytes(rng.integers(97, 123, (9_000,), dtype=np.uint8))
    needles = [
        hay[6_000:8_100],   # 2100-byte huge needle past window=4999
        hay[0:5_000],       # 5000-byte huge needle at 0 (sets overlap=4999)
        bytes(5_000),       # absent huge
    ]
    port, jax = scanners(needles, window_bytes=1)
    assert (port.window, port.overlap) == (jax.window, jax.overlap) == (4_999, 4_999)
    held(port, jax, lambda s: s.find_in_chunks(iter([hay]), early_stop=False), firsts(hay, needles))
    held(port, jax, lambda s: s.count_in_chunks(iter([hay])), counts(hay, needles))
    held(port, jax, lambda s: s.positions_in_chunks(iter([hay])), host_positions(hay, needles))


def test_stream_file_short_read_is_not_last(tmp_path):
    """A file window whose remaining bytes fall in (window, window +
    overlap) short-reads but is NOT final: the exactly-once clamp stays."""
    blob = bytearray(b"c" * 1_005)
    blob[1_001:1_003] = b"AB"
    blob = bytes(blob)
    p = tmp_path / "s.bin"
    p.write_bytes(blob)
    # len-8 needle sets overlap=7: window 0 reads 1005 in (1000, 1007).
    needles = [b"AB", b"zzzzzzzz"]
    port, jax = scanners(needles, window_bytes=1_000)
    held(port, jax, lambda s: s.count_in_file(str(p)), counts(blob, needles))
    held(port, jax, lambda s: s.positions_in_file(str(p)), host_positions(blob, needles))
    held(port, jax, lambda s: s.find_in_file(str(p), early_stop=False), [1_001, -1])


def _ingest_threads():
    return [t for t in threading.enumerate() if t.name == "sliceslice-ingest" and t.is_alive()]


def test_stream_prefetch_parity_and_shutdown(tmp_path, corpus):
    """Pipelined ingestion (a background reader) gives the serial path's
    answers for find, count and positions, and an early stop retires the
    reader promptly."""
    p = tmp_path / "c.bin"
    p.write_bytes(corpus)
    needles = [corpus[0:6], corpus[640_000:640_009], b"NOPE!", corpus[-4:]]
    serial = StreamingScanner(needles, window_bytes=150_000, prefetch=0, device=CPU)
    piped, jax = scanners(needles, window_bytes=150_000, prefetch=3)
    exp = firsts(corpus, needles)
    assert list(serial.find_in_file(str(p), early_stop=False)) == exp
    held(piped, jax, lambda s: s.find_in_file(str(p), early_stop=False), exp)
    assert list(serial.count_in_file(str(p))) == counts(corpus, needles)
    held(piped, jax, lambda s: s.count_in_file(str(p)), counts(corpus, needles))
    exp_pos = host_positions(corpus, needles)
    assert same_positions(serial.positions_in_file(str(p)), exp_pos)
    held(piped, jax, lambda s: s.positions_in_file(str(p)), exp_pos)
    # Early stop mid-stream: all needles hit in window 0; the reader must
    # wind down instead of reading the rest of the stream.
    early, jearly = scanners([corpus[10:20]], window_bytes=100_000, check_every=1, prefetch=2)
    held(early, jearly, lambda s: s.find_in_file(str(p), early_stop=True), [10])
    for _ in range(50):
        if not _ingest_threads():
            break
        threading.Event().wait(0.1)
    assert not _ingest_threads()


def test_stream_prefetch_propagates_reader_errors(corpus):
    """An exception raised by the window source reaches the caller (not
    swallowed in the reader thread)."""

    def bad_chunks():
        yield corpus[:100_000]
        raise OSError("disk gone")

    for sc in scanners([b"zz"], window_bytes=50_000, prefetch=2):
        with pytest.raises(OSError, match="disk gone"):
            sc.count_in_chunks(bad_chunks())


def test_warmup_covers_every_stream_shape(tmp_path, corpus):
    """After warmup(), find, count and positions streams over a file whose
    size is an exact multiple of the window and over one with a short
    trailing window are exact and allocate no window buffer (the port's
    counterpart of the JAX test's zero mid-stream compiles: every window
    takes one fixed layout, in buffers the warmup made)."""
    win = 65_536
    needles = [
        corpus[0:1],                     # 1-byte
        corpus[100:106],                 # t=2
        corpus[5_000:5_011],             # t=3
        corpus[win - 4 : win + 4],       # boundary straddle
        b"NOPE!",
        corpus[-9:],
    ]
    port, jax = scanners(needles, window_bytes=win)
    port.warmup()
    jax.warmup()
    made = port.buffer_allocations
    for name, blob in (("exact", corpus[: 4 * win]), ("ragged", corpus[: 3 * win + 17_123])):
        p = tmp_path / f"{name}.bin"
        p.write_bytes(blob)
        held(port, jax, lambda s: s.find_in_file(str(p), early_stop=False), firsts(blob, needles))
        held(port, jax, lambda s: s.count_in_file(str(p)), counts(blob, needles))
        held(port, jax, lambda s: s.positions_in_file(str(p)), host_positions(blob, needles))
    assert port.buffer_allocations == made


def test_warmup_covers_huge_needle_stream(tmp_path, corpus):
    """warmup() also runs the huge needles' prefix filter and both verify
    tiers; a first huge stream after it allocates no window buffer."""
    win = 65_536
    k = MAX_NEEDLE_LEN + 500
    needles = [corpus[10_000 : 10_000 + k], corpus[0:7]]
    port, jax = scanners(needles, window_bytes=win)
    port.warmup()
    jax.warmup()
    made = port.buffer_allocations
    blob = corpus[: 3 * win]
    p = tmp_path / "h.bin"
    p.write_bytes(blob)
    held(port, jax, lambda s: s.find_in_file(str(p), early_stop=False), firsts(blob, needles))
    assert port.buffer_allocations == made


def test_stream_stats_attribution(tmp_path, corpus):
    """The stats summary attributes the wall time (read / prep / upload /
    dispatch / drain) and reports per-window latency percentiles, under
    the JAX package's keys."""
    p = tmp_path / "c.bin"
    p.write_bytes(corpus)
    needles = [corpus[0:6], b"NOPE!"]
    port, jax = scanners(needles, window_bytes=200_000)
    held(port, jax, lambda s: s.find_in_file(str(p), early_stop=False), firsts(corpus, needles))
    s, js = port.stats_summary(), jax.stats_summary()
    assert set(js) <= set(s)
    assert s["mode"] == "find" and s["windows"] == js["windows"] == 5
    assert s["bytes"] == js["bytes"] >= len(corpus)
    for k in ("read_s", "buf_wait_s", "prep_s", "upload_s", "dispatch_s", "drain_s"):
        assert s[k] >= 0.0, k
    assert s["window_p50_ms"] <= s["window_p90_ms"]
    held(port, jax, lambda s: s.count_in_file(str(p)), counts(corpus, needles))
    assert port.stats_summary()["mode"] == "count" and port.stats_summary()["windows"] == 5


def test_device_fold_primitives_exact():
    """The device folds: int64 counts exact past 2^32 (the JAX two-limb
    fold's case), and the first-match fold lexicographic in (window,
    local), with absent windows never overwriting."""
    import jax.numpy as jnp

    totals = torch.zeros((1,), dtype=torch.int64)
    hi = lo = jnp.zeros((1,), jnp.uint32)
    step = (1 << 31) - 1
    for _ in range(5):  # total 5*(2^31-1) > 2^32
        tstreaming._count_fold(totals, torch.tensor([step], dtype=torch.int32))
        hi, lo = jstreaming._count_fold64(hi, lo, jnp.asarray([step], jnp.int32))
    assert int(totals[0]) == (int(np.asarray(hi)[0]) << 32) + int(np.asarray(lo)[0]) == 5 * step

    window = 1_000
    best = torch.full((3,), tstreaming.INT64_MAX, dtype=torch.int64)
    bw = bl = jnp.full((3,), SENTINEL, jnp.int32)
    # window 0: needle1 at 7; window 1: needle0 at 9, needle1 at 3 (later
    # window must NOT beat window 0's hit), needle2 absent throughout.
    for w, local in enumerate(([SENTINEL, 7, SENTINEL], [9, 3, SENTINEL])):
        tstreaming._first_fold(best, torch.tensor(local, dtype=torch.int32), w * window)
        bw, bl = jstreaming._first_fold(bw, bl, jnp.int32(w), jnp.asarray(local, jnp.int32))
    assert list(np.asarray(bw)) == [1, 0, SENTINEL] and list(np.asarray(bl)) == [9, 7, SENTINEL]
    assert best.tolist() == [window + 9, 7, tstreaming.INT64_MAX]


def test_device_folds_equal_the_jax_folds_on_seeded_windows():
    """The port's int64 folds against the JAX ``_count_fold64`` and
    ``_first_fold`` over 24 seeded windows of 64 needles: counts up to
    2^31 - 1 per window (totals past 2^32), first offsets mostly absent,
    window bases from 2^32 - 3 windows on."""
    import jax.numpy as jnp

    rng = np.random.default_rng(808)
    n, windows, window = 64, 24, 1 << 27
    base0 = 2**32 - 3 * window
    totals = torch.zeros((n,), dtype=torch.int64)
    best = torch.full((n,), tstreaming.INT64_MAX, dtype=torch.int64)
    hi = lo = jnp.zeros((n,), jnp.uint32)
    bw = bl = jnp.full((n,), SENTINEL, jnp.int32)
    for w in range(windows):
        cnt = rng.integers(0, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
        local = rng.integers(0, window, n, dtype=np.int64).astype(np.int32)
        local[rng.random(n) < 0.9] = SENTINEL
        tstreaming._count_fold(totals, torch.from_numpy(cnt))
        hi, lo = jstreaming._count_fold64(hi, lo, jnp.asarray(cnt))
        tstreaming._first_fold(best, torch.from_numpy(local), base0 + w * window)
        bw, bl = jstreaming._first_fold(bw, bl, jnp.int32(w), jnp.asarray(local))
    jtot = (np.asarray(hi).astype(np.int64) << 32) + np.asarray(lo).astype(np.int64)
    assert np.array_equal(totals.numpy(), jtot) and jtot.max() > 2**32
    bw, bl = np.asarray(bw).astype(np.int64), np.asarray(bl).astype(np.int64)
    jbest = np.where(bw < SENTINEL, base0 + bw * window + bl, tstreaming.INT64_MAX)
    assert np.array_equal(best.numpy(), jbest)
    found = jbest < tstreaming.INT64_MAX
    assert (~found).any() and (jbest[found] > 2**32).any() and (jbest[found] < 2**32).any()


def test_stream_pool_survives_repeated_early_stops(tmp_path, corpus):
    """Early-stopped streams leave buffers in flight; every buffer returns
    to the pool, so repeated early stops never starve a later full stream
    (and the port allocates no buffer for them)."""
    p = tmp_path / "c.bin"
    p.write_bytes(corpus)
    needles = [corpus[10:20], b"NOPE!"]
    port, jax = scanners(needles, window_bytes=65_536, check_every=1, prefetch=2)
    port.warmup()
    made = port.buffer_allocations
    for _ in range(6):
        held(port, jax, lambda s: s.find_in_file(str(p), early_stop=True), [10, -1])
    held(port, jax, lambda s: s.find_in_file(str(p), early_stop=False), [10, -1])
    held(port, jax, lambda s: s.count_in_file(str(p)), counts(corpus, needles))
    assert port.buffer_allocations == made


def test_streaming_int64_offsets_past_2gib():
    """Offsets beyond the int32 range are exact through the public API
    (tests/test_utils.py's case): ``start_offset`` puts the second
    window's base past 2^32."""
    win = 2**16
    start = 2**32 - win + 64
    data = bytes(win) + b"xxxxxneedle-in-window-two" + bytes(503)
    port, jax = scanners([b"needle", b"absent-needle"], window_bytes=win)
    got = held(port, jax, lambda s: s.find_in_chunks(iter([data[:40_000], data[40_000:]]), early_stop=False,
                                                     start_offset=start), [start + win + 5, -1])
    assert got[0] > 2**32
    held(port, jax, lambda s: s.count_in_chunks(iter([data])), [1, 0])
    held(port, jax, lambda s: s.positions_in_chunks(iter([data]), start_offset=start),
         [np.array([start + win + 5]), np.zeros(0, np.int64)])


def _fuzz_bytes(alphabet: bytes, max_size: int):
    return st_.builds(bytes, st_.lists(st_.sampled_from(list(alphabet)), min_size=0, max_size=max_size))


@settings(max_examples=12, deadline=None)
@given(
    hay=_fuzz_bytes(b"ab", 60_000),
    needles=st_.lists(_fuzz_bytes(b"ab", 16), min_size=1, max_size=4),
    window=st_.integers(min_value=9_000, max_value=30_000),
)
def test_fuzz_streaming_windows(hay, needles, window):
    """Random window geometry x period-heavy content (tests/test_fuzz.py's
    case): find and count parity across window boundaries."""
    needles = [nd or b"a" for nd in needles]
    port, jax = scanners(needles, window_bytes=window)

    def chunks():
        step = max(1, window // 3 + 7)
        for i in range(0, len(hay), step):
            yield hay[i : i + step]

    held(port, jax, lambda s: s.find_in_chunks(chunks(), early_stop=False), firsts(hay, needles))
    held(port, jax, lambda s: s.count_in_chunks(chunks()), counts(hay, needles))


def meshes(shape):
    """A (data, needle) mesh of the port's cells on the CPU and the JAX
    package's mesh of its virtual CPU devices, alike."""
    from sliceslice_tpu.parallel import make_mesh as jax_mesh
    from sliceslice_tpu_torch.parallel import make_mesh

    return make_mesh(shape, device=CPU), jax_mesh(shape)


def test_stream_sharded_mesh(corpus):
    """Streaming x sharding: each window scanned over a 4x2 mesh, find and
    count exact at window and shard boundaries, in both packages."""
    mesh, jmesh = meshes((4, 2))
    win = 200_000
    edge = win + 50_048  # the port's first shard boundary inside window 1
    needles = [corpus[win - 6 : win + 6], corpus[450_000:450_010], b"XYZQ", corpus[-4:],
               corpus[edge - 3 : edge + 5]]
    port = StreamingScanner(needles, window_bytes=win, mesh=mesh, device=CPU)
    jax = jstreaming.StreamingScanner(needles, window_bytes=win, mesh=jmesh)
    assert shard_bytes_for(port._wcap, 4) == edge - win

    def chunks():
        for i in range(0, len(corpus), 77_777):
            yield corpus[i : i + 77_777]

    held(port, jax, lambda s: s.find_in_chunks(chunks(), early_stop=False), firsts(corpus, needles))
    held(port, jax, lambda s: s.count_in_chunks(chunks()), counts(corpus, needles))


def test_stream_sharded_positions(corpus):
    """Streaming x sharding for positions: per-window sharded two-tier
    positions, the int64 window base added past 2^33."""
    mesh, jmesh = meshes((4, 2))
    win = 200_000
    needles = [corpus[win - 6 : win + 6], corpus[0:3], b"XYZQ", corpus[-4:]]
    port = StreamingScanner(needles, window_bytes=win, mesh=mesh, device=CPU)
    jax = jstreaming.StreamingScanner(needles, window_bytes=win, mesh=jmesh)
    held(port, jax, lambda s: s.positions_in_chunks(iter([corpus]), start_offset=2**33),
         host_positions(corpus, needles, 2**33))


# -- the port's own contracts ----------------------------------------------


@pytest.mark.parametrize("prefetch", [0, 3])
def test_no_window_buffer_after_warmup(tmp_path, corpus, prefetch):
    """warmup fills both pools; streams of every mode, file and chunks,
    early stops and a stream whose windows outnumber the pool many times
    over, then allocate no window buffer."""
    p = tmp_path / "c.bin"
    p.write_bytes(corpus[:300_000])
    needles = [corpus[:4], corpus[150_000:150_010], b"NOPE!"]
    sc = StreamingScanner(needles, window_bytes=12_000, check_every=1, prefetch=prefetch, device=CPU)
    assert sc.buffer_allocations == 0
    sc.warmup()
    made = sc.buffer_allocations
    assert made == max(prefetch, 1) + 2 + tstreaming.DEVICE_BUFFERS
    data = corpus[:300_000]
    assert list(sc.find_in_file(str(p), early_stop=True)) == firsts(data, needles)
    assert list(sc.find_in_chunks(iter([data]), early_stop=False)) == firsts(data, needles)
    assert list(sc.count_in_file(str(p))) == counts(data, needles)
    assert same_positions(sc.positions_in_chunks(iter([data])), host_positions(data, needles))
    assert sc.stats["windows"] == 25 > 3 * (made - tstreaming.DEVICE_BUFFERS)
    assert sc.buffer_allocations == made


def test_no_ingest_thread_outlives_a_stream(tmp_path, corpus):
    """After an early stop and after a reader error, no ingest thread is
    left alive, and every host buffer is back in the pool."""
    p = tmp_path / "c.bin"
    p.write_bytes(corpus)
    sc = StreamingScanner([corpus[10:20]], window_bytes=50_000, check_every=1, prefetch=2, device=CPU)
    assert list(sc.find_in_file(str(p), early_stop=True)) == [10]
    assert sc.stats["windows"] == 1
    assert not _ingest_threads()
    pool = sc._host_q.qsize()

    def bad_chunks():
        yield corpus[:200_000]
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        sc.positions_in_chunks(bad_chunks())
    assert not _ingest_threads()
    assert sc._host_q.qsize() == pool == max(sc.prefetch, 1) + 2


def test_every_window_takes_the_kernel_layout(monkeypatch, tmp_path):
    """Windows of at most SHORT_HAY_BYTES (where the JAX package scans
    flat and counts on the host) lie in the one layout of the fixed
    ``_wcap`` size, in the pooled device buffers, final window included."""
    rng = np.random.default_rng(3)
    data = bytes(rng.integers(97, 100, (20_000,), dtype=np.uint8))
    needles = [data[1_000:1_005], data[4_090:4_110], b"ccc", b"zz"]
    sc = StreamingScanner(needles, window_bytes=3_000, device=CPU)
    assert sc._wcap <= SHORT_HAY_BYTES
    seen = []
    ingest = sc._ingest

    def spy(factory):
        for dh, wlen, is_last in ingest(factory):
            seen.append((dh.length, dh.flat.numel(), dh.flat.data_ptr(), is_last))
            yield dh, wlen, is_last

    monkeypatch.setattr(sc, "_ingest", spy)
    assert list(sc.find_in_chunks(iter([data]), early_stop=False)) == firsts(data, needles)
    assert list(sc.count_in_chunks(iter([data]))) == counts(data, needles)
    assert same_positions(sc.positions_in_chunks(iter([data])), host_positions(data, needles))
    total = padded_total(sc._wcap, sc._kh)
    pool = {t.data_ptr() for t in sc._dev_pool}
    assert len(seen) == 3 * 7 and sum(s[3] for s in seen) == 3
    assert all(s[:2] == (sc._wcap, total) and s[2] in pool for s in seen)


def test_late_reader_writes_only_its_own_streams_stats(monkeypatch):
    """A reader stuck in a slow read past the stream's join ends later and
    adds its ``read_s`` to the stats of the stream that started it, never
    to those of the next stream on the same scanner."""
    late = 0.5
    monkeypatch.setattr(tstreaming, "READER_JOIN_S", 0.05)
    nd = b"needle"
    sc = StreamingScanner([nd], window_bytes=4096, check_every=1, prefetch=1, device=CPU)
    blocked, gate = threading.Event(), threading.Event()
    drain = sc._drain

    def drain_once_the_reader_blocks():
        blocked.wait(30)  # the early stop comes only while the reader is in its read
        drain()

    monkeypatch.setattr(sc, "_drain", drain_once_the_reader_blocks)

    def slow_chunks():
        yield nd + bytes(4096)  # one full window, the needle at 0: an early stop
        blocked.set()
        gate.wait(30)
        yield bytes(4096)

    before = set(_ingest_threads())
    assert list(sc.find_in_chunks(slow_chunks())) == [0]
    first = sc.stats
    (stuck,) = set(_ingest_threads()) - before  # still in its read, past the join
    time.sleep(late)  # the stuck read grows past `late` seconds

    def fast_chunks():
        gate.set()
        stuck.join(30)  # the late read's time has been added by now
        yield b"xx" + nd

    assert list(sc.find_in_chunks(fast_chunks())) == [2]
    assert not stuck.is_alive()
    assert first["read_s"] >= late
    assert sc.stats is not first and sc.stats_summary()["read_s"] < late / 2
