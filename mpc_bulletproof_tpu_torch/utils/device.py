"""Device selection: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def normalize_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index: ``"cuda"`` names the
    current card (``cuda:0`` unless the caller made another current), so
    ``"cuda"`` and ``"cuda:0"`` key one entry of a per-device cache."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_device(device) -> torch.device:
    """``device`` as a normalised ``torch.device`` (:func:`normalize_device`);
    raises when a CUDA device is asked for and none is there (nothing falls
    back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    return normalize_device(dev)
