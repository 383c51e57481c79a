"""The Fiat-Shamir transcript on tensors: the hash chain of
:class:`..transcript.HashChainTranscript`, kept on the card.

The state is a ``(32,)`` int64 byte tensor threaded through absorbs and
challenges (:mod:`.keccak_t` is the hash).  Byte layouts are the host
transcript's:

* ``absorb``:           ``state' = keccak256(state || pad_label(l) || msg)``
* ``challenge_scalar``: ``state' = keccak256(state || pad_label(l))``; the
  scalar is ``LE(state' || keccak256(state')) mod r``;
* points absorb as ``x || y`` 32-byte LE felts, the identity as 64 zeros;
* scalars absorb as 32 LE bytes.

So a whole log-round protocol runs with no host round trip; the host
transcript takes the final state afterwards.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import P
from . import kernels, limb
from .keccak import pad_label
from .keccak_t import keccak256
from .limb import FP, FR, NW


def bytes_tensor(data: bytes, device) -> torch.Tensor:
    return torch.as_tensor(np.frombuffer(data, dtype=np.uint8).astype(np.int64), device=device)


def absorb(state: torch.Tensor, label: bytes, msg: torch.Tensor) -> torch.Tensor:
    """``state' = keccak256(state || pad_label(label) || msg)``."""
    data = torch.cat([state, bytes_tensor(pad_label(label), state.device), msg])
    return keccak256(data, data.shape[0])


def challenge_scalar(state: torch.Tensor, label: bytes):
    """Returns ``(state', u)`` with ``u`` a canonical ``(NW, 1)`` scalar."""
    data = torch.cat([state, bytes_tensor(pad_label(label), state.device)])
    new_state = keccak256(data, data.shape[0])
    high = keccak256(new_state, 32)
    return new_state, bytes_to_scalar_mod_r(torch.cat([new_state, high]))


def bytes_to_scalar_mod_r(bytes64: torch.Tensor) -> torch.Tensor:
    """Read ``(64, *batch)`` int64 bytes little-endian, reduce mod r ->
    ``(NW, *batch)`` canonical; one ``(64,)`` value gives ``(NW, 1)``."""
    if bytes64.dim() == 1:
        bytes64 = bytes64[:, None]
    pieces = bytes64[0::2] | (bytes64[1::2] << 8)  # (32, *batch) 16-bit
    return limb.reduce_512(pieces, FR)


def felt_bytes_le(words: torch.Tensor) -> torch.Tensor:
    """Canonical ``(NW, k)`` words -> ``(32, k)`` little-endian bytes."""
    sh = torch.arange(0, 64, 8, dtype=torch.int64, device=words.device)
    return ((words[:, None, :] >> sh[None, :, None]) & 0xFF).reshape(8 * NW, -1)


def points_transcript_bytes(x: torch.Tensor, y: torch.Tensor, is_id: torch.Tensor) -> torch.Tensor:
    """Affine coords ``(NW, k)`` and identity flags ``(k,)`` -> ``(64, k)``
    transcript encodings."""
    enc = torch.cat([felt_bytes_le(x), felt_bytes_le(y)], dim=0)
    return torch.where(is_id[None, :], torch.zeros_like(enc), enc)


def lazy_points_to_affine(pts: torch.Tensor):
    """``(3, NW, k)`` Montgomery projective points -> standard-form affine
    ``(x, y, is_id)``, ``(NW, k)`` coords.  One batched Fermat inversion;
    the Montgomery factors cancel in ``X/Z`` and ``Y/Z``.  (The name is the
    JAX package's, whose coordinates are lazy; here they are canonical.)"""
    x, y, z = pts[0], pts[1], pts[2]
    is_id = (z == 0).all(dim=0)
    z_safe = torch.where(is_id[None, :], limb.from_const(1, (1,), z.device), z).contiguous()
    zinv = kernels.mod_pow_static(z_safe, P - 2, FP)
    return limb.mod_mul(x, zinv, FP), limb.mod_mul(y, zinv, FP), is_id
