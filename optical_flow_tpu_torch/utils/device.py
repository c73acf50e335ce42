"""Which device an entry point runs on.

A tensor stays on its own device. Host data (numpy arrays, lists) goes to
the card unless the caller names another device (``device="cpu"``), and
without a card that raises: nothing carries on on the CPU unasked.
"""

from __future__ import annotations

import numpy as np
import torch


def canonical_device(device) -> torch.device:
    """``torch.device(device)`` with a bare ``'cuda'`` bound to the current
    card, so that two names of one device compare equal. A CUDA device
    without a card raises: nothing carries on on the CPU unasked."""
    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{str(d)!r} was asked for but no CUDA device is available; "
                "pass device='cpu' (devices=['cpu'] for a mesh) to run on the CPU"
            )
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


def call_device(*inputs, device=None) -> torch.device:
    """``device`` if given; else the device of the first tensor among
    ``inputs``; else the card."""
    if device is not None:
        return canonical_device(device)
    for x in inputs:
        if isinstance(x, torch.Tensor):
            return x.device
    return canonical_device("cuda")


def as_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    """``x`` (a tensor or anything numpy takes) on ``device``, in ``dtype``
    (default: its own)."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype or x.dtype)


def host_array(x) -> np.ndarray:
    """``x`` (a tensor on any device, or anything numpy takes) as a numpy
    array on the host."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
