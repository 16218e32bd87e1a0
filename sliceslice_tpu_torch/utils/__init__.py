"""Utilities: ingestion, the host SWAR rung and the measurement harness."""

from .io import load_haystack, map_file
from .profiling import HBM_ROOFLINE, Measurement, card, measure

__all__ = ["load_haystack", "map_file", "HBM_ROOFLINE", "Measurement", "card", "measure"]
