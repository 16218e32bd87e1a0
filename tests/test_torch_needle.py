"""The port's needle tables against the JAX package's, and the port's
independence from JAX.

Both packages compile needles to the same probe tables; every comparison
here is exact (tolerance 0: integer tables and halo sizes)."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import sliceslice_tpu.needle as jn
import sliceslice_tpu_torch.needle as tn

PORT = pathlib.Path(__file__).resolve().parent.parent / "sliceslice_tpu_torch"


def test_all_words_tables_identical(words):
    """Tables for every word of words.txt, in one table and per width
    group, are byte-identical to the JAX package's."""
    for t_max in (None, 1, 2, 3, 4, 5, 6, 8, 16):
        sel = words if t_max is None else [w for w in words if jn.num_probes(len(w)) <= t_max]
        jv, jm, jl = jn.build_probe_table(sel, t_max=t_max)
        tv, tm, tl = tn.build_probe_table(sel, t_max=t_max)
        for a, b in ((jv, tv), (jm, tm), (jl, tl)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    for w in words:
        assert tn.probe_program(w) == jn.probe_program(w)


def test_halo_and_probe_counts_identical():
    for t in range(1, 513):
        assert tn.needed_halo_for_t(t) == jn.needed_halo_for_t(t)
    for k in range(0, tn.MAX_NEEDLE_LEN + 2):
        assert tn.num_probes(k) == jn.num_probes(k)
        assert tn.needed_halo(k) == jn.needed_halo(k), k
    assert tn.MAX_NEEDLE_LEN == jn.MAX_NEEDLE_LEN == 2048
    assert tn.needed_halo(33) == 4 * 10 - 1  # t=9 rounds up to even beyond 8


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7, 8, 9, 31, 33, 64, 100, 1000, 2048])
def test_random_needle_tables_identical(k, rng):
    needles = [bytes(rng.integers(0, 256, (k,), dtype=np.uint8)) for _ in range(5)]
    needles += [nd[: max(1, k - 1)] for nd in needles[:2]]
    for a, b in zip(jn.build_probe_table(needles), tn.build_probe_table(needles)):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize(
    "args",
    [(b"abcd", 4), (b"abcd", -1), (b"", None), (b"x" * 2049, None), (b"abc", 3)],
)
def test_needle_contract_errors_identical(args):
    with pytest.raises(ValueError):
        jn.Needle(*args)
    with pytest.raises(ValueError):
        tn.Needle(*args)


def test_needle_position_and_conversions():
    for nd, p in ((b"abcd", None), (b"abcd", 0), ("héllo", 2), (bytearray(b"xy"), 1)):
        assert tn.Needle(nd, p).position == jn.Needle(nd, p).position
        assert tn.Needle(nd, p).data == jn.Needle(nd, p).data
    assert tn.as_bytes(memoryview(b"z")) == b"z"
    assert tn.as_bytes(np.frombuffer(b"np", dtype=np.uint8)) == b"np"
    for bad in (np.zeros(3, np.int32), 123):
        with pytest.raises(TypeError):
            tn.as_bytes(bad)
    with pytest.raises(ValueError):
        tn.build_probe_table([b"abcdefghij"], t_max=2)


def test_port_imports_without_jax():
    """The port never imports jax: importing it (and its searchers) with
    jax blocked succeeds and searches."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import sliceslice_tpu_torch as st\n"
        "from sliceslice_tpu_torch import interop\n"
        "from sliceslice_tpu_torch.utils import profiling, native\n"
        "assert st.DynamicSearcher(b'ipsum', device='cpu').find(b'lorem ipsum dolor' * 600) == 6\n"
        "assert 'sliceslice_tpu' not in sys.modules\n"
        "print('ok')\n"
    )
    root = str(PORT.parent)
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=root, timeout=120
    )
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_native_helper_is_the_ports_own():
    """The host helper's sources and its built library lie inside the
    port package, never under the repository's root ``csrc/``, which the
    JAX package builds from."""
    from sliceslice_tpu_torch.utils import native

    for path in [*native._SRCS, native._so_path()]:
        p = pathlib.Path(path).resolve()
        assert p.is_relative_to(PORT.resolve()), p
    assert all(pathlib.Path(src).is_file() for src in native._SRCS)
    assert pathlib.Path(native._so_path()).parent == (PORT / "csrc" / "build").resolve()


def test_port_sources_import_no_jax():
    """No module of the port names jax or the JAX package in an import."""
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "sliceslice_tpu"), (path, name)


def _eval_probes(window: bytes, values, masks) -> bool:
    """What a probe program means on a byte window: slot t compares the
    little-endian word at byte 4t (zero past the window) under its mask."""
    for t, (v, m) in enumerate(zip(values, masks)):
        if (tn.pack_le32(window[4 * t : 4 * t + 4].ljust(4, b"\x00")) ^ v) & m:
            return False
    return True


@pytest.mark.parametrize("k", list(range(1, 40)) + [61, 64, 100, 1000])
def test_probe_program_exact(k):
    """The JAX package's program, and its meaning: the needle's window
    passes, any one-byte corruption within it fails, bytes past it never
    count."""
    rng = np.random.default_rng(1000 + k)
    needle = bytes(rng.integers(0, 256, (k,), dtype=np.uint8))
    values, masks = tn.probe_program(needle)
    assert (values, masks) == jn.probe_program(needle)
    assert len(values) == tn.num_probes(k) == -(-k // 4)
    pad = bytes(rng.integers(0, 256, (8,), dtype=np.uint8))
    assert _eval_probes(needle + pad, values, masks)
    for i in range(k):
        corrupted = bytearray(needle + pad)
        corrupted[i] ^= 0x01
        assert not _eval_probes(bytes(corrupted), values, masks), i
    tail = bytearray(needle + pad)
    for i in range(k, len(tail)):
        tail[i] ^= 0xFF
    assert _eval_probes(bytes(tail), values, masks)


def test_probe_program_empty():
    assert tn.probe_program(b"") == jn.probe_program(b"") == ((), ())


def test_build_probe_table_mixed():
    """One table of mixed widths, the empty needle among them: the JAX
    package's table, inactive slots mask 0, the final mask a byte prefix."""
    needles = [b"", b"a", b"abc", b"abcd", b"abcdefgh", b"abcdefghij"]
    values, masks, lengths = tn.build_probe_table(needles)
    for a, b in zip((values, masks, lengths), jn.build_probe_table(needles)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert values.shape == (6, 3) and list(lengths) == [0, 1, 3, 4, 8, 10]
    assert masks[0].sum() == 0
    assert masks[1, 1] == 0 and masks[1, 0] == 0xFF
    assert masks[3, 0] == 0xFFFFFFFF
    assert masks[5, 2] == 0xFFFF
    with pytest.raises(ValueError):
        tn.build_probe_table([b"abcdefghij"], t_max=2)


def test_position_recorded_but_ignored_by_device_kernels():
    """``position`` is checked and recorded, and changes no table and no
    answer: the program is the same at every position (and the JAX
    package's), and the kernel layout's find gives 5,000 at each."""
    from sliceslice_tpu import DynamicSearcher as JaxDynamicSearcher
    from sliceslice_tpu_torch import DynamicSearcher

    nd = b"hay-needle!"
    programs = {tn.Needle(nd, p).probes for p in range(len(nd))}
    assert programs == {jn.Needle(nd, 0).probes}
    assert tn.Needle(nd, 2).position == 2
    hay = b"xx" * 2500 + nd + b"tail"
    for p in range(0, len(nd), 3):
        assert DynamicSearcher(nd, p, device="cpu").find(hay) == 5000
    assert JaxDynamicSearcher(nd, 2).find(hay) == 5000
