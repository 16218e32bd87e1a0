"""Portable torch-ops searcher — the counterpart of the JAX package's
``XlaSearcher``: the same probe algorithm as plain tensor code on any
device, with no kernel.  The differential path the kernels are held
against."""

from __future__ import annotations

import numpy as np

from ..needle import probe_program
from ..ops import torch_backend
from ..ops.layout import DeviceHaystack
from ..searcher import SearcherBase


class TorchSearcher(SearcherBase):
    def __init__(self, needle, position=None, *, device="cpu"):
        super().__init__(needle, position, device=device)
        if self.needle.size == 0:
            raise ValueError("empty needle")
        vals, msks = probe_program(self.needle.data)
        self._values = np.asarray(vals, np.uint32)
        self._masks = np.asarray(msks, np.uint32)

    def _find_device(self, dh: DeviceHaystack):
        k = self.needle.size
        end = dh.length - k + 1
        if not dh.tiled:
            return torch_backend.find_flat(dh.flat, self._values, self._masks, end)
        dh = dh.ensure_kh(k)
        return torch_backend.find_cols(dh.flat, self._values, self._masks, end)
