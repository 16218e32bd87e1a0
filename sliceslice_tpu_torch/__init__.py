"""sliceslice_tpu_torch — the PyTorch and CUDA port of sliceslice_tpu.

The same substring-search API and answers as the JAX package, for one
NVIDIA Hopper card: a haystack is laid out once on a device, and needles
are searched over it, counted, or listed at every offset, by hand-written
CUDA kernels (``csrc/*.cu``), built with ``nvcc`` at first use; word lists
are swept against each other pair by pair.  Every entry point runs on the
card unless the caller passes ``device="cpu"``, where every kernel runs as
its plain PyTorch version; without a card the default raises.  The port
imports torch and numpy, never jax.

Public API::

    from sliceslice_tpu_torch import DynamicSearcher, BatchedSearcher, preprocess
    DynamicSearcher(b"ipsum").find(b"lorem ipsum dolor")        # -> 6
    hay = preprocess(open("corpus", "rb").read())               # on the card
    BatchedSearcher([b"a", b"needle"]).find_all(hay)
    BatchedSearcher([b"a", b"needle"]).count_all(hay)
    BatchedSearcher([b"a", b"needle"]).positions_all(hay)
    DynamicSearcher(b"aa").count_in(b"aaaa")                   # -> 3
    DynamicSearcher(b"aa", device="cpu").positions(b"aaaa")    # -> array([0, 1, 2])
    PairwiseSearcher([b"ab", b"abc"]).contains_matrix()
    StreamingScanner([b"needle"]).find_in_file("huge.log")     # any length
"""

from . import config
from .config import SENTINEL
from .models import (
    BatchedSearcher,
    CudaSearcher,
    DynamicSearcher,
    MemchrSearcher,
    NaiveSearcher,
    TorchSearcher,
    naive_find,
    searcher_for_size,
)
from .needle import MAX_NEEDLE_LEN, Needle, build_probe_table, probe_program
from .ops import DeviceHaystack, preprocess
from .ops.pairwise import PairwiseSearcher, pairwise_contains_all
from .searcher import EmptyNeedleSearcher, SearcherBase, overlapping_count
from .utils.streaming import StreamingScanner

__all__ = [
    "config",
    "Needle",
    "MAX_NEEDLE_LEN",
    "probe_program",
    "build_probe_table",
    "BatchedSearcher",
    "PairwiseSearcher",
    "pairwise_contains_all",
    "DynamicSearcher",
    "MemchrSearcher",
    "NaiveSearcher",
    "CudaSearcher",
    "TorchSearcher",
    "naive_find",
    "searcher_for_size",
    "SENTINEL",
    "DeviceHaystack",
    "preprocess",
    "SearcherBase",
    "overlapping_count",
    "EmptyNeedleSearcher",
    "StreamingScanner",
]
