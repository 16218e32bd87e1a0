"""The port's entry points take the card by default: on a host without
one the default raises, and the CPU (the kernels' plain versions) runs
only when the caller passes ``device="cpu"``.  ``torch.cuda.is_available``
is patched to False, so these run alike with or without a card."""

import numpy as np
import pytest
import torch

from sliceslice_tpu_torch import (
    BatchedSearcher,
    CudaSearcher,
    DynamicSearcher,
    MemchrSearcher,
    NaiveSearcher,
    PairwiseSearcher,
    StreamingScanner,
    TorchSearcher,
    interop,
    pairwise_contains_all,
    preprocess,
)
from sliceslice_tpu_torch import cli
from sliceslice_tpu_torch.models.huge import HugeNeedleSearcher
from sliceslice_tpu_torch.needle import build_probe_table
from sliceslice_tpu_torch.ops.layout import resolve_device
from sliceslice_tpu_torch.parallel import ShardedBatchedSearcher, make_mesh
from sliceslice_tpu_torch.parallel.distributed import assemble_global_corpus
from sliceslice_tpu_torch.scripts import kernel_probe
from sliceslice_tpu_torch.utils.io import load_haystack

_TABLE = build_probe_table([b"ab"], t_max=1)
ENTRY_POINTS = {
    "preprocess": lambda **kw: preprocess(b"abc" * 4000, **kw),
    "DynamicSearcher": lambda **kw: DynamicSearcher(b"ab", **kw),
    "DynamicSearcher-empty": lambda **kw: DynamicSearcher(b"", **kw),
    "DynamicSearcher-huge": lambda **kw: DynamicSearcher(b"ab" * 1100, **kw),
    "HugeNeedleSearcher": lambda **kw: HugeNeedleSearcher(b"ab" * 1100, **kw),
    "load_haystack": lambda **kw: load_haystack("data/words.txt", **kw),
    "cli.make_searcher": lambda **kw: cli.make_searcher("cuda", b"ab", **kw),
    "cli.make_searcher-count": lambda **kw: cli.make_searcher("count", b"ab,c", **kw),
    "cli.make_searcher-stream": lambda **kw: cli.make_searcher("stream", b"ab,c", **kw),
    "cli.make_searcher-sharded": lambda **kw: cli.make_searcher("sharded", b"ab,c", "2x1", **kw),
    "make_mesh": lambda **kw: make_mesh(**kw),
    "make_mesh-shape": lambda **kw: make_mesh((4, 2), **kw),
    "ShardedBatchedSearcher": lambda **kw: ShardedBatchedSearcher([b"a", b"bc"], make_mesh((2, 1), **kw)),
    "assemble_global_corpus": lambda **kw: assemble_global_corpus(b"abc" * 100, b"", 300, 32, make_mesh(**kw)),
    "DynamicSearcher.with_position": lambda **kw: DynamicSearcher.with_position(b"ab", 1, **kw),
    "CudaSearcher": lambda **kw: CudaSearcher(b"abcde", **kw),
    "CudaSearcher.with_position": lambda **kw: CudaSearcher.with_position(b"abcde", 2, **kw),
    "TorchSearcher": lambda **kw: TorchSearcher(b"ab", **kw),
    "NaiveSearcher": lambda **kw: NaiveSearcher(b"ab", **kw),
    "MemchrSearcher": lambda **kw: MemchrSearcher(b"a", **kw),
    "BatchedSearcher": lambda **kw: BatchedSearcher([b"a", b"bc"], **kw),
    "PairwiseSearcher": lambda **kw: PairwiseSearcher([b"a", b"bc"], **kw),
    "StreamingScanner": lambda **kw: StreamingScanner([b"a", b"bc"], **kw),
    "StreamingScanner-huge": lambda **kw: StreamingScanner([b"a", b"bc" * 1100], **kw),
    "pairwise_contains_all": lambda **kw: pairwise_contains_all([b"a", b"ab"], **kw),
    "interop.haystack": lambda **kw: interop.haystack(b"abc" * 4000, 12_000, 32, **kw),
    "interop.batched_searcher": lambda **kw: interop.batched_searcher(
        [b"ab"], [(_TABLE[0], _TABLE[1], _TABLE[2], np.arange(1))], **kw),
    "interop.pairwise_searcher": lambda **kw: interop.pairwise_searcher(
        [b"ab"], _TABLE[0].T, _TABLE[1].T, _TABLE[2], 512, **kw),
}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_raises_without_a_card(no_card, name):
    with pytest.raises(ValueError, match="no CUDA device; pass device='cpu'"):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_cpu_only_when_asked(no_card, name):
    made = ENTRY_POINTS[name](device="cpu")
    dev = getattr(made, "device", None)
    assert dev is None or torch.device(dev).type == "cpu"


def test_resolve_device(no_card):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    for name in ("cuda", "cuda:0", torch.device("cuda", 1)):
        with pytest.raises(ValueError, match="no CUDA device"):
            resolve_device(name)


def test_grep_cli_takes_the_card_unless_asked(no_card, capsys):
    with pytest.raises(ValueError, match="no CUDA device"):
        cli.main(["count", "ab,c", "data/words.txt"])
    assert cli.main(["count", "ab,c", "data/words.txt"], device="cpu") == 0
    assert capsys.readouterr().out.startswith("data/words.txt: ab: ")


def test_grep_cli_streams_on_the_card_unless_asked(no_card, capsys):
    with pytest.raises(ValueError, match="no CUDA device"):
        cli.main(["stream", "ab,c", "data/words.txt"])
    assert cli.main(["stream", "ab,c", "data/words.txt"], device="cpu") == 0
    assert capsys.readouterr().out.startswith("data/words.txt: ab: match at ")


def test_probe_cli_takes_the_card_unless_asked(no_card, capsys):
    with pytest.raises(ValueError, match="no CUDA device"):
        kernel_probe.main(["t=1", "n=8", "k=1", "count"])
    assert kernel_probe.main(["t=1", "n=8", "k=1", "device=cpu", "count"]) == 0
    assert capsys.readouterr().out.startswith("CPU, plain versions")
