"""Searcher model family — the counterparts of the JAX package's searchers."""

from .batched import BatchedSearcher
from .cuda_searcher import (
    SPECIALIZED,
    SPECIALIZED_SIZES,
    CudaSearcher,
    searcher_for_size,
)
from .dynamic import DynamicSearcher
from .memchr import MemchrSearcher
from .naive import NaiveSearcher, naive_find, naive_windows_find
from .torch_searcher import TorchSearcher

__all__ = [
    "BatchedSearcher",
    "DynamicSearcher",
    "MemchrSearcher",
    "NaiveSearcher",
    "naive_find",
    "naive_windows_find",
    "CudaSearcher",
    "TorchSearcher",
    "SPECIALIZED",
    "SPECIALIZED_SIZES",
    "searcher_for_size",
]
