"""The port's harness against the JAX package's: the conformance run, the
fuzz campaign, the random size matrix and the competitor rows, on the CPU
(the kernels' plain versions; the JAX scripts run Pallas in interpret mode
and are imported by path, unchanged).  Every comparison is exact.  Then
the contracts: a wrong answer makes the campaign fail and say
``MISMATCH``, every script's default device raises without a card, and
nothing here writes into the repository."""

import importlib
import importlib.util
import pathlib
import subprocess

import numpy as np
import pytest
import torch

from sliceslice_tpu_torch import BatchedSearcher
from sliceslice_tpu_torch.benchmarks import competitors, random_matrix
from sliceslice_tpu_torch.scripts import conformance, fuzz_campaign
from sliceslice_tpu_torch.utils import native

REPO = pathlib.Path(__file__).resolve().parent.parent
#: The CPU tests run the kernels' plain versions: the port's entry points
#: take the card unless asked for the CPU.
CPU = "cpu"
#: Every harness module with a ``main`` of the port.
SCRIPTS = ["scripts.conformance", "scripts.fuzz_campaign", "scripts.bigscan_check", "scripts.breakeven",
           "scripts.oneshot_decompose", "scripts.perf_long", "scripts.scale_check", "scripts.stream_bench",
           "benchmarks.random_matrix", "benchmarks.competitors", "bench"]


def tree_state() -> tuple:
    """What a write into the repository would change: git's view of the
    tree and the top-level files' sizes and times."""
    try:
        status = subprocess.run(["git", "status", "--porcelain", "--untracked-files=all"], cwd=REPO,
                                capture_output=True, text=True, timeout=60).stdout
    except OSError:
        status = None
    files = sorted((p.name, p.stat().st_size, p.stat().st_mtime_ns) for p in REPO.iterdir() if p.is_file())
    return status, files


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree_before():
    return tree_state()


def jax_script(path: str):
    """A JAX script of the repository, imported by path, unchanged."""
    spec = importlib.util.spec_from_file_location("jax_" + pathlib.Path(path).stem, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tree_snapshot_taken_first(tree_before):
    assert tree_before[1], "the repository's top level holds files"


def test_conformance_reduced_equals_jax():
    port = conformance.run_conformance(full=False, device=CPU)
    ref = jax_script("scripts/conformance.py").run_conformance(full=False, round_no=0)
    for key in ("full", "long_words", "long_mismatches", "short_words", "short_pairs", "short_total_checked",
                "short_mismatches"):
        assert port[key] == ref[key], key
    assert port["long_mismatches"] == port["short_mismatches"] == 0
    assert port["long_words"] == 96 and port["short_total_checked"] == 96 * 96


def test_conformance_takes_expectations_and_counts_mismatches():
    """Expectations passed in are the ones compared: one wrong expected
    offset and one wrong expected pair are one mismatch each."""
    hay, words = conformance.corpus(full=False)
    exp_long = np.array([hay.find(w) for w in words])
    exp_short = conformance.pair_oracle(sorted(words, key=len))
    exp_long[3] += 1
    exp_short[5, 7] = 12345
    got = conformance.run_conformance(full=False, device=CPU, exp_long=exp_long, exp_short=exp_short)
    assert got["long_mismatches"] == 1 and got["short_mismatches"] == 1


@pytest.mark.parametrize("seed", [0, 20260818, 99])
def test_gen_needles_byte_for_byte_as_jax(seed):
    jf = jax_script("scripts/fuzz_campaign.py")
    assert fuzz_campaign.KS == jf.KS
    for L in (4096, 50_000):
        hay = np.random.default_rng(seed + L).integers(0, 256, L, dtype=np.uint8).tobytes()
        for boundary in (L, L // 3, 32768, 5):
            a = fuzz_campaign.gen_needles(hay, 4, np.random.default_rng(seed), boundary)
            b = jf.gen_needles(hay, 4, np.random.default_rng(seed), boundary)
            c = fuzz_campaign.gen_needles(hay, 4, np.random.default_rng(seed), lambda k, b=boundary: b)
            assert a == b == c


def test_queue_boundary_is_the_find_queue_chunk():
    from sliceslice_tpu_torch import preprocess
    from sliceslice_tpu_torch.ops import scan_kernel

    dh = preprocess(bytes(300_000), kh=64, device=CPU)
    for k in (1, 9, 64):
        assert fuzz_campaign.queue_boundary(dh, k) == scan_kernel.FIND_CHUNK
    # A 4,096-byte layout is shorter than one chunk: its boundary lies past
    # the corpus's end, so no needle straddles one, as on the JAX flat rung.
    short = preprocess(bytes(4096), device=CPU)
    assert fuzz_campaign.queue_boundary(short, 3) == scan_kernel.FIND_CHUNK > 4096


def test_fuzz_campaign_one_round_passes(capsys):
    assert fuzz_campaign.main(["1", "4242", "--device", CPU]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "cpu (no card)"
    assert out[-1].startswith("fuzz campaign: ") and out[-1].split(" failures (")[0].endswith(", 0")
    assert "MISMATCH" not in "\n".join(out)


def test_fuzz_campaign_fails_on_a_wrong_offset(monkeypatch, capsys):
    right = BatchedSearcher.find_all
    monkeypatch.setattr(BatchedSearcher, "find_all", lambda self, hay: right(self, hay) + 1)
    assert fuzz_campaign.main(["1", "4242", "--device", CPU]) == 1
    out = capsys.readouterr().out
    assert "FIND MISMATCH" in out
    assert not out.splitlines()[-1].split(" failures (")[0].endswith(" 0")


def test_random_matrix_equals_jax():
    port = random_matrix.collect(device=CPU)
    ref = jax_script("benchmarks/random_matrix.py").collect()
    assert [(r["needle"], r["haystack"], r["match"]) for r in port] == \
        [(r["needle"], r["haystack"], r["match"]) for r in ref]
    needle = (REPO / "data" / "needle").read_bytes()
    hay = (REPO / "data" / "haystack").read_bytes()
    for r in port:
        assert r["offset"] == hay[:r["haystack"]].find(needle[:r["needle"]])
        assert r["port_us"] > 0 and r["py_us"] > 0
    assert "| port dynamic |" in random_matrix.table(port)


def test_random_matrix_raises_on_a_wrong_answer(monkeypatch):
    from sliceslice_tpu_torch import DynamicSearcher

    monkeypatch.setattr(DynamicSearcher, "find", lambda self, hay: 0)
    with pytest.raises(random_matrix.Mismatch):
        random_matrix.collect(device=CPU)
    assert random_matrix.main(["--device", CPU]) == 1


@pytest.mark.skipif(not native.available(), reason="no C++ toolchain")
def test_competitors_host_rows_agree_with_bytes_find():
    hay, words = conformance.corpus(full=True)
    hay, words = hay[:100_000], words[:400]
    rows = competitors.collect_host(hay, words)
    assert set(rows) == {"long_py_bytes_find_ms", "long_native_swar_ms", "long_native_twoway_ms",
                         "short_native_swar_allpairs_ms"}
    for key in ("long_py_bytes_find_ms", "long_native_swar_ms", "long_native_twoway_ms"):
        lo, med, hi = rows[key]
        assert 0 < lo <= med <= hi
    exp = [hay.find(w) for w in words]
    assert list(native.swar_find_batch(hay, words)) == exp
    assert list(native.twoway_find_batch(hay, words)) == exp
    ws = sorted(words, key=len)[:120]
    assert (native.swar_pairwise(ws) == (conformance.pair_oracle(ws) >= 0)).all()


@pytest.mark.parametrize("name", SCRIPTS)
def test_default_device_raises_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"sliceslice_tpu_torch.{name}")
    argv = ["1"] if name == "scripts.fuzz_campaign" else []
    with pytest.raises(ValueError, match="no CUDA device"):
        mod.main(argv)


def test_repository_unchanged(tree_before):
    """Nothing above wrote into the repository (no BENCH_r*,
    CONFORMANCE_r*, README block or svg; no other file)."""
    assert tree_state() == tree_before
