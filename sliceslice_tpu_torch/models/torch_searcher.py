"""Portable torch-ops searcher — the counterpart of the JAX package's
``XlaSearcher``: the same probe algorithm as plain tensor code on any
device, with no kernel.  The differential path the kernels are held
against.  Its count and its positions' match bitmap run as plain torch
ops on the layout's device, so a layout on the card is never counted or
scanned on the host."""

from __future__ import annotations

import numpy as np

from ..needle import probe_program
from ..ops import scan_kernel, torch_backend
from ..ops.layout import DeviceHaystack
from ..searcher import SearcherBase


class TorchSearcher(SearcherBase):
    _bitmap = staticmethod(scan_kernel.match_bitmap_plain)

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

    def _count_device(self, dh: DeviceHaystack):
        if not dh.tiled:
            raise NotImplementedError  # flat layout on the CPU: the host count applies
        k = self.needle.size
        dh = dh.ensure_kh(k)
        return torch_backend.count_cols(dh.flat, self._values, self._masks, dh.length - k + 1)
