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


def to_host_into(x: torch.Tensor, dst: np.ndarray) -> np.ndarray:
    """``x`` copied into the caller's host array ``dst`` (of ``x``'s shape
    and dtype) by one blocking copy, and ``dst`` returned: a readback, as
    :func:`to_host`'s, that lands where the caller keeps its answers, in
    whatever memory ``dst`` has (nothing page-locked is made or kept)."""
    host = torch.from_numpy(dst)
    if host.dtype != x.dtype or host.shape != x.shape:
        raise ValueError(f"dst must be {x.dtype} of shape {tuple(x.shape)}")
    if not x.is_cuda:
        host.copy_(x)
        return dst
    with tracing.span("sliceslice.readback"):
        host.copy_(x)
    tracing.count("readbacks")
    tracing.count("readback_bytes", dst.nbytes)
    return dst


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
