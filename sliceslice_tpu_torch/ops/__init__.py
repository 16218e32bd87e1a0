"""Compute ops: device layout, probe math, kernel wrappers, torch paths."""

from . import layout, scan_kernel, scan_math, torch_backend
from .layout import DeviceHaystack, preprocess
from ..config import SENTINEL

__all__ = [
    "layout",
    "scan_kernel",
    "scan_math",
    "torch_backend",
    "DeviceHaystack",
    "preprocess",
    "SENTINEL",
]
