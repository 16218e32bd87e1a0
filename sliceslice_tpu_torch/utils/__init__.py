"""Utilities: ingestion, streams of any length, the host SWAR rung and the
measurement harness."""

from .io import load_haystack, map_file
from .profiling import HBM_ROOFLINE, Measurement, card, measure
from .streaming import StreamingScanner

__all__ = ["load_haystack", "map_file", "HBM_ROOFLINE", "Measurement", "card", "measure",
           "StreamingScanner"]
