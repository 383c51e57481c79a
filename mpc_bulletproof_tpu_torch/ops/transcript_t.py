"""The Fiat-Shamir transcript on tensors: the hash chain of
:class:`..transcript.HashChainTranscript`, kept on the card.

The state is a ``(32,)`` int64 byte tensor threaded through absorbs and
challenges.  Byte layouts are the host transcript's:

* ``absorb``:           ``state' = keccak256(state || pad_label(l) || msg)``
* ``challenge_scalar``: ``state' = keccak256(state || pad_label(l))``; the
  scalar is ``LE(state' || keccak256(state')) mod r``;
* points absorb as ``x || y`` 32-byte LE felts, the identity as 64 zeros;
* scalars absorb as 32 LE bytes.

Every absorb fits one keccak block (at most 135 bytes with the state), so
a run of absorbs, and a challenge after them, is a run of padded 136-byte
blocks: :func:`absorb_many` builds them on the device (the labels and the
padding are a cached template a call site, the messages go in by one
``index_put``) and hashes the whole run with one
:func:`..kernels.keccak_transcript` call, the kernel for a CUDA state and
its plain version for a CPU one.  So a whole log-round protocol runs with
no host round trip; the host transcript takes the final state afterwards.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import P
from . import kernels, limb
from .keccak import pad_label
from .keccak_t import RATE
from .limb import FP, FR, NW

_LAYOUTS: dict = {}


def _layout(labels: tuple, lens: tuple, consts: tuple | None, challenge: bytes | None, device):
    """The padded blocks of a run, cached a call site: a ``(j, 136)`` int64
    template (bytes 0-31 left for the state, then each label, the host
    messages ``consts`` if given, and the padding), and the flat block
    positions of the device messages' bytes (column-major: byte ``b`` of
    message ``i`` at ``b * j + i``, as an ``(L, j)`` column matrix reads)."""
    key = (labels, lens, consts, challenge, str(device))
    hit = _LAYOUTS.get(key)
    if hit is not None:
        return hit
    rows = list(zip(labels, lens)) + ([(challenge, 0)] if challenge is not None else [])
    template = np.zeros((len(rows), RATE), dtype=np.int64)
    pos = np.zeros((max(lens, default=0), len(labels)), dtype=np.int64)
    for i, (label, n) in enumerate(rows):
        lab = np.frombuffer(pad_label(label), dtype=np.uint8)
        off = 32 + len(lab)
        if off + n > RATE - 1:
            raise ValueError("single-block keccak only: message longer than 135 bytes")
        template[i, 32:off] = lab
        if consts is not None and i < len(consts):
            template[i, off : off + n] = np.frombuffer(consts[i], dtype=np.uint8)
        elif i < len(labels):
            pos[:, i] = i * RATE + off + np.arange(n)
        template[i, off + n] ^= 0x01
        template[i, RATE - 1] ^= 0x80
    hit = (torch.as_tensor(template, device=device), torch.as_tensor(pos.reshape(-1), device=device))
    _LAYOUTS[key] = hit
    return hit


def absorb_many(state: torch.Tensor, labels, msgs, challenge: bytes | None = None):
    """Absorb ``msgs[i]`` under ``labels[i]`` in order, then, with
    ``challenge``, squeeze that challenge: one keccak launch for the run.
    ``msgs`` is an ``(L, j)`` int64 byte tensor (column ``i`` the ``i``-th
    message; all of one length) or ``j`` host ``bytes`` (constants, kept in
    the cached template).  Returns ``(state', u)``: ``u`` the challenge's
    canonical ``(NW, 1)`` scalar, or None without one."""
    labels = tuple(labels)
    if isinstance(msgs, torch.Tensor):
        if msgs.dim() != 2 or msgs.shape[1] != len(labels):
            raise ValueError(f"absorb_many: expected (L, {len(labels)}) message columns, got {tuple(msgs.shape)}")
        lens, consts = (msgs.shape[0],) * len(labels), None
    else:
        consts = tuple(bytes(m) for m in msgs)
        if len(consts) != len(labels):
            raise ValueError("absorb_many: one message a label")
        lens = tuple(len(m) for m in consts)
    template, pos = _layout(labels, lens, consts, challenge, state.device)
    blocks = template
    if consts is None and pos.numel():
        blocks = template.reshape(-1).index_put((pos,), msgs.reshape(-1)).reshape(template.shape)
    out = kernels.keccak_transcript(state, blocks, challenge is not None)
    if challenge is None:
        return out, None
    return out[:32], bytes_to_scalar_mod_r(out)


def absorb(state: torch.Tensor, label: bytes, msg: torch.Tensor) -> torch.Tensor:
    """``state' = keccak256(state || pad_label(label) || msg)``."""
    return absorb_many(state, [label], msg.reshape(-1, 1))[0]


def challenge_scalar(state: torch.Tensor, label: bytes):
    """Returns ``(state', u)`` with ``u`` a canonical ``(NW, 1)`` scalar."""
    return absorb_many(state, [], (), challenge=label)


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
