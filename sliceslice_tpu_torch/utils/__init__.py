"""Utilities: the host SWAR rung and the measurement harness."""

from .profiling import HBM_ROOFLINE, Measurement, card, measure

__all__ = ["HBM_ROOFLINE", "Measurement", "card", "measure"]
