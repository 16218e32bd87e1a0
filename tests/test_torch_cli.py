"""The port's grep CLI, its ingestion helpers and its examples against the
JAX package — the mirror of tests/test_cli.py (but its stream and sharded
cases, which wait for the port's streaming and ``parallel/``): for every
case the port's printed lines and exit code, with ``main(...,
device="cpu")``, equal the JAX CLI's on the same file, with the backend
names mapped (``cuda`` for ``pallas``, ``torch`` for ``xla``)."""

import numpy as np
import pytest
import torch

import sliceslice_tpu.cli as jcli
import sliceslice_tpu.utils.io as jio
import sliceslice_tpu_torch.cli as tcli
from sliceslice_tpu_torch.examples import corpus_scan, serving_loop
from sliceslice_tpu_torch.searcher import _host_positions, overlapping_count
from sliceslice_tpu_torch.utils import io as tio

#: The CPU tests run the kernels' plain versions: the port's entry points
#: take the card unless asked for the CPU.
CPU = "cpu"
#: The JAX CLI's name of each port backend that is named differently.
JAX_NAME = {"cuda": "pallas", "torch": "xla"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def corpus_file(tmp_path):
    p = tmp_path / "corpus.txt"
    p.write_bytes(b"lorem ipsum dolor sit amet " * 100)
    return str(p)


def both(capsys, argv):
    """(exit code, stdout) of the port's CLI on ``argv``, required equal
    to the JAX CLI's on the same arguments with the backend name mapped."""
    got = tcli.main(list(argv), device=CPU)
    out = capsys.readouterr().out
    jargv = list(argv)
    jargv[0] = JAX_NAME.get(jargv[0], jargv[0])
    ref = jcli.main(jargv)
    assert (got, out) == (ref, capsys.readouterr().out), argv
    return got, out


@pytest.mark.parametrize("backend", ["dynamic", "cuda", "torch", "naive"])
def test_cli_backends(backend, corpus_file, capsys):
    assert both(capsys, [backend, "ipsum", corpus_file]) == (0, f"{corpus_file}: match at 6\n")
    assert both(capsys, [backend, "zebra", corpus_file]) == (1, f"{corpus_file}: no match\n")


def test_cli_memchr(corpus_file, capsys):
    assert both(capsys, ["memchr", "d", corpus_file]) == (0, f"{corpus_file}: match at 12\n")


def test_cli_batched(corpus_file, capsys):
    rc, out = both(capsys, ["batched", "ipsum,zebra,amet", corpus_file])
    assert rc == 0
    assert "ipsum: match at 6" in out and "zebra: no match" in out


def test_cli_invalid_backend(corpus_file):
    # reference: panics on an invalid backend (examples/grep.rs:39)
    with pytest.raises(SystemExit, match="unknown backend"):
        tcli.search_in_file("avx512", b"x", corpus_file, device=CPU)
    with pytest.raises(SystemExit, match="unknown backend"):
        jcli.search_in_file("avx512", b"x", corpus_file)


def test_cli_usage(capsys):
    assert tcli.main([], device=CPU) == jcli.main([]) == 2
    assert "usage:" in capsys.readouterr().err


def test_cli_count(corpus_file, capsys):
    rc, out = both(capsys, ["count", "ipsum,zebra,or", corpus_file])
    assert rc == 0
    assert "ipsum: 100" in out and "zebra: 0" in out
    assert "or: 200" in out  # "lorem" + "dolor" per repeat


def test_cli_positions(corpus_file, capsys):
    rc, out = both(capsys, ["positions", "ipsum,zebra", corpus_file])
    assert rc == 0
    assert "ipsum: 6,33,60" in out  # every 27 bytes
    assert "(+0 more)" not in out and "zebra: no match" in out
    # 300 occurrences: only the first 100 print, the rest elided
    assert both(capsys, ["positions", "m", corpus_file])[1].endswith("(+200 more)\n")


@pytest.mark.parametrize("arg", [b"a,b,c", rb"a\,b,c", rb"a\\,b", rb"a\\\,b", b"", b"a,", rb"a\nb"])
def test_split_needles_escaping(arg):
    assert tcli.split_needles(arg) == jcli.split_needles(arg)
    assert tcli.split_needles(rb"a\,b,c") == [b"a,b", b"c"]


def test_cli_count_escaped_comma(tmp_path, capsys):
    p = tmp_path / "hay.txt"
    p.write_bytes(b"x,y and x and y," * 10)
    rc, out = both(capsys, ["count", r"x\,y,y\,", str(p)])
    assert rc == 0 and "x,y: 10" in out and "y,: 10" in out


def test_cli_multiple_files_reuse_searcher(tmp_path, capsys):
    p1 = tmp_path / "a.txt"
    p2 = tmp_path / "b.txt"
    p1.write_bytes(b"xxipsumyy" * 500)
    p2.write_bytes(b"nothing here" * 500)
    rc, out = both(capsys, ["batched", "ipsum,zz", str(p1), str(p2)])
    assert rc == 0
    assert f"{p1}: ipsum: match at 2" in out and f"{p2}: ipsum: no match" in out


def test_cli_mesh_flag_edge_cases(tmp_path, capsys):
    """An unknown ``--meshes`` flag is not consumed (it lands in the
    backend slot and errors); a trailing bare ``--mesh`` is a usage
    error, in both CLIs."""
    p = tmp_path / "h.txt"
    p.write_bytes(b"hello world")
    with pytest.raises(SystemExit, match="unknown backend"):
        tcli.main(["--meshes", "2x4", "dynamic", "hello", str(p)], device=CPU)
    with pytest.raises(SystemExit, match="unknown backend"):
        jcli.main(["--meshes", "2x4", "dynamic", "hello", str(p)])
    assert tcli.main(["dynamic", "hello", str(p), "--mesh"], device=CPU) == 2
    assert "usage:" in capsys.readouterr().err
    assert jcli.main(["dynamic", "hello", str(p), "--mesh"]) == 2
    assert "usage:" in capsys.readouterr().err


@pytest.mark.parametrize("argv, item", [
    (["stream", "abc"], 14), (["stream-count", "abc"], 14), (["stream-positions", "abc"], 14),
    (["sharded", "abc"], 15), (["sharded-count", "abc"], 15), (["sharded-positions", "abc"], 15),
    (["--mesh", "4x2", "sharded", "abc"], 15), (["--mesh=2x4", "batched", "abc"], 15),
])
def test_cli_not_ported_backends_are_usage_errors(tmp_path, capsys, argv, item):
    """The JAX CLI's streaming and sharded backends and ``--mesh`` come
    with later parts of the port: exit 2 with the usage line and the
    ROADMAP item that brings them."""
    p = tmp_path / "h.txt"
    p.write_bytes(b"abc" * 100)
    assert tcli.main(argv + [str(p)], device=CPU) == 2
    err = capsys.readouterr().err
    assert err.startswith("usage:") and f"ROADMAP queue 1 item {item}" in err
    backend = argv[2] if argv[0] == "--mesh" else argv[0]
    if backend in tcli.NOT_PORTED:
        with pytest.raises(SystemExit, match=f"item {item}"):
            tcli.make_searcher(backend, b"abc", device=CPU)


def _huge_case(tmp_path):
    """A 300 KB file and needles over it: a huge one present twice, a huge
    one absent, a short one."""
    rng = np.random.default_rng(11)
    data = bytearray(rng.integers(97, 123, (300_000,), dtype=np.uint8))
    huge = bytes(data[120_000:122_600])
    data[250_000:252_600] = huge
    p = tmp_path / "big.txt"
    p.write_bytes(bytes(data))
    return bytes(data), str(p), [huge, b"q" * 2_100 + b"!", bytes(data[7:13])]


def test_cli_count_with_a_huge_needle(tmp_path, capsys):
    data, path, needles = _huge_case(tmp_path)
    arg = ",".join(nd.decode() for nd in needles)
    rc, out = both(capsys, ["count", arg, path])
    assert rc == 0
    assert out.splitlines() == [f"{path}: {nd.decode()}: {overlapping_count(data, nd)}" for nd in needles]
    assert overlapping_count(data, needles[0]) == 2


def test_cli_huge_needle_dynamic_batched_positions(tmp_path, capsys):
    data, path, needles = _huge_case(tmp_path)
    huge = needles[0].decode()
    assert both(capsys, ["dynamic", huge, path]) == (0, f"{path}: match at 120000\n")
    rc, out = both(capsys, ["batched", ",".join(nd.decode() for nd in needles), path])
    assert rc == 0 and out.splitlines()[1].endswith(": no match")
    rc, out = both(capsys, ["positions", huge + ",zzzz", path])
    assert out.splitlines() == [f"{path}: {huge}: 120000,250000", f"{path}: zzzz: "
                                + (",".join(map(str, _host_positions(data, b"zzzz")[:100].tolist()))
                                   or "no match")]


def test_map_file_and_load_haystack(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(b"")
    assert tio.map_file(p).size == jio.map_file(p).size == 0
    body = bytes(range(256)) * 40
    p.write_bytes(body)
    assert tio.map_file(p).tobytes() == jio.map_file(p).tobytes() == body
    dh = tio.load_haystack(p, kh=100, device=CPU)
    jdh = jio.load_haystack(p, kh=100)
    assert dh.device.type == "cpu" and dh.tiled == jdh.tiled and dh.host_bytes == body
    assert (dh.length, dh.kh) == (jdh.length, jdh.kh)
    assert bytes(dh.flat[: dh.length].numpy()) == body
    assert tio.load_haystack(p, keep_host=False, device=CPU).host_bytes is None


def test_examples_run_on_the_cpu(tmp_path, capsys):
    hay = b"lorem ipsum dolor sit amet, consectetur " * 300
    (tmp_path / "c.txt").write_bytes(hay)
    (tmp_path / "w.txt").write_bytes(b"ipsum\nzebra\n\namet\n")
    corpus_scan.main(str(tmp_path / "c.txt"), str(tmp_path / "w.txt"), device=CPU)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"2/3 needles found in {len(hay):,} bytes")
    assert out[1:] == ["  'ipsum'              -> offset 6", "  'zebra'              -> absent",
                       "  'amet'               -> offset 22"]
    serving_loop.main(str(tmp_path / "c.txt"), str(tmp_path / "w.txt"), batches=2, per_batch=6, device=CPU)
    out = capsys.readouterr().out
    assert out.startswith(f"12 queries over {len(hay):,} bytes in ") and "matched)" in out
