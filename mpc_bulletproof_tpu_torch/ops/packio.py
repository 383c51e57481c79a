"""One flat output, one device-to-host copy.

The fused prover's outputs are about sixteen small tensors (transcript
state, commitment coordinates, proof scalars, the per-round L/R points).
Each copy to the host synchronizes with the card, so they are packed into
one flat int64 tensor and copied once.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_device(leaves) -> torch.Tensor:
    """Concatenate tensors into one flat int64 tensor."""
    return torch.cat([t.reshape(-1).to(torch.int64) for t in leaves])


def unpack_np(flat, shapes):
    """Split a flat host array back into arrays of ``shapes``."""
    flat = np.asarray(flat)
    out = []
    off = 0
    for shp in shapes:
        k = int(np.prod(shp)) if shp else 1
        out.append(flat[off : off + k].reshape(shp))
        off += k
    if off != flat.size:
        raise ValueError(f"unpack mismatch: consumed {off} of {flat.size}")
    return out
