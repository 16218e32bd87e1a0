"""Corpus ingestion, the counterpart of ``sliceslice_tpu/utils/io.py``:
map a file without copying (the reference's memmap2 usage,
examples/grep.rs:49-50) and lay it out on a device once."""

from __future__ import annotations

import mmap
import os
from typing import Union

import numpy as np
import torch

from ..ops.layout import DeviceHaystack, preprocess


def map_file(path: Union[str, os.PathLike]) -> np.ndarray:
    """Memory-map a file as a read-only uint8 array (no copy)."""
    size = os.path.getsize(path)
    if size == 0:
        return np.zeros((0,), dtype=np.uint8)
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    return np.frombuffer(mm, dtype=np.uint8)


def load_haystack(
    path: Union[str, os.PathLike],
    kh: int = 64,
    keep_host: bool = True,
    *,
    device: Union[str, torch.device] = "cuda",
) -> DeviceHaystack:
    """mmap plus the device layout in one step (grep-style ingest), on the
    card unless the caller passes ``device="cpu"``."""
    return preprocess(map_file(path), kh=kh, keep_host=keep_host, device=device)
