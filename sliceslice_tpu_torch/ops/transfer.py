"""The copies between the host and a card on the request paths, in one
place, so that each is a span and counted (:mod:`..utils.tracing`):
``sliceslice.readback`` with ``readbacks`` / ``readback_bytes``, and
``sliceslice.upload`` with ``uploads`` / ``upload_bytes``.  A readback
waits for the work queued before it, so its span holds the host's wait on
the device as well as the copy.  Tensors already on the CPU are neither
spanned nor counted."""

from __future__ import annotations

import numpy as np
import torch

from ..utils import tracing


def to_host(x: torch.Tensor) -> np.ndarray:
    """``x`` as a numpy array on the host."""
    if not x.is_cuda:
        return x.numpy()
    with tracing.span("sliceslice.readback"):
        out = x.cpu().numpy()
    tracing.count("readbacks")
    tracing.count("readback_bytes", out.nbytes)
    return out


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """The host array ``a`` as a tensor on ``device``."""
    t = torch.from_numpy(a)
    if torch.device(device).type != "cuda":
        return t.to(device)
    with tracing.span("sliceslice.upload"):
        t = t.to(device)
    tracing.count("uploads")
    tracing.count("upload_bytes", a.nbytes)
    return t
