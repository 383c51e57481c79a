"""The Fiat-Shamir transcript on tensors: the hash chain of
:class:`..transcript.HashChainTranscript`, kept on the card.

A state is ``(4,)`` int64 words (``(T, 4)`` for T transcripts at once),
the host transcript's 32 bytes read little-endian.  Byte layouts are the
host transcript's:

* absorb:    ``state' = keccak256(state || pad_label(l) || msg)``
* challenge: ``state' = keccak256(state || pad_label(l))``; the scalar is
  ``LE(state' || keccak256(state')) mod r``;
* points absorb as ``x || y`` 32-byte LE felts, the identity as 64 zeros;
* scalars absorb as 32 LE bytes, u64s as 8.

Labels pad to 32 bytes and every message is whole 64-bit words, so every
block of a run is whole words, and every absorb fits one keccak block (at
most 135 bytes with the state).  A run of absorbs and challenges is
described by its steps, ``(label, msg)`` pairs: ``msg`` the number of
device message words the step takes (in order) from the message tensor,
or host ``bytes`` (a constant, kept in the template), or None for a
challenge.  :func:`absorb_many` hashes a whole run with one
:func:`..kernels.keccak_transcript` call, the kernel for CUDA tensors and
its plain version for CPU ones: the template (labels, constants, padding)
and the layout are built once a run on the host and cached, the messages
go in as the words the caller holds, and the challenges come out reduced.
So a whole log-round protocol runs with no host round trip; the host
transcript takes the final state afterwards.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import P
from ..utils.device import normalize_device
from . import kernels, limb
from .keccak import pad_label
from .keccak_t import RATE
from .limb import FP, FR

_PLANS: dict = {}


def _plan(steps: tuple, device) -> kernels.TranscriptPlan:
    """The run's :class:`..kernels.TranscriptPlan`, cached a run: the
    template ``(J, 17)`` words (each label, host constants, the 0x01 after
    the message and the final 0x80) and the layout ``(J, 4)`` that
    :func:`..kernels.keccak_transcript` reads, checked on the host."""
    key = (steps, normalize_device(device))
    hit = _PLANS.get(key)
    if hit is not None:
        return hit
    template = np.zeros((len(steps), RATE), dtype=np.uint8)
    layout = np.zeros((len(steps), 4), dtype=np.int64)
    n_words = 0
    for i, (label, msg) in enumerate(steps):
        lab = np.frombuffer(pad_label(label), dtype=np.uint8)
        off = 32 + len(lab)
        n = 0 if msg is None else len(msg) if isinstance(msg, bytes) else 8 * msg
        if n % 8:
            raise ValueError("transcript messages are whole 64-bit words")
        if off + n > RATE - 1:
            raise ValueError("single-block keccak only: an absorb longer than 135 bytes")
        template[i, 32:off] = lab
        if isinstance(msg, bytes):
            template[i, off : off + n] = np.frombuffer(msg, dtype=np.uint8)
        elif msg is not None:
            layout[i, :3] = off // 8, msg, n_words
            n_words += msg
        else:
            layout[i, 3] = 1
        template[i, off + n] ^= 0x01
        template[i, RATE - 1] ^= 0x80
    hit = kernels.transcript_plan(template.view("<u8").view(np.int64), layout, device)
    _PLANS[key] = hit
    return hit


def absorb_many(state: torch.Tensor, steps, msgs: torch.Tensor | None = None):
    """Run ``steps`` (module docstring) from ``state``: ``(4,)`` words, or
    ``(T, 4)`` for T transcripts of the same steps.  ``msgs`` holds the
    steps' device message words in order: ``(W,)``, or ``(T, W)`` with
    ``state``; None when the run takes none.  One keccak launch for the
    run.  Returns ``(state', u)``: ``u`` the challenges in run order,
    canonical ``(NW, C)`` (``(T, NW, C)``), or None without one."""
    steps = tuple((bytes(label), msg if msg is None or isinstance(msg, int) else bytes(msg))
                  for label, msg in steps)
    plan = _plan(steps, state.device)
    one = state.dim() == 1
    starts = state.reshape(-1, 4)
    if msgs is None:
        msgs = starts.new_zeros((starts.shape[0], 0))
    msgs = msgs.reshape(starts.shape[0], -1)
    if msgs.shape[1] != plan.words:
        raise ValueError(f"absorb_many: the steps take {plan.words} message words, got {msgs.shape[1]}")
    out, u = kernels.keccak_transcript(starts.contiguous(), plan, msgs.contiguous())
    if one:
        out, u = out[0], u[0]
    return out, (u if plan.challenges else None)


def absorb(state: torch.Tensor, label: bytes, msg: torch.Tensor) -> torch.Tensor:
    """``state' = keccak256(state || pad_label(label) || msg)``, ``msg`` words."""
    return absorb_many(state, [(label, msg.numel())], msg)[0]


def challenge_scalar(state: torch.Tensor, label: bytes):
    """Returns ``(state', u)`` with ``u`` a canonical ``(NW, 1)`` scalar."""
    return absorb_many(state, [(label, None)])


def state_words(state: bytes) -> np.ndarray:
    """A host transcript's 32-byte state as ``(4,)`` int64 words."""
    return np.frombuffer(state, dtype="<u8").view(np.int64).copy()


def state_bytes(words) -> bytes:
    """``(4,)`` int64 words (a host array) as the host transcript's 32 bytes."""
    return np.asarray(words, dtype=np.int64).astype("<i8").tobytes()


def scalars_words(scalars: torch.Tensor) -> torch.Tensor:
    """Canonical ``(NW, k)`` scalars -> ``(4 k,)`` message words, scalar by
    scalar (each its 32 LE bytes)."""
    return scalars.T.reshape(-1)


def points_words(x: torch.Tensor, y: torch.Tensor, is_id: torch.Tensor) -> torch.Tensor:
    """Affine coords ``(NW, k)`` and identity flags ``(k,)`` -> ``(8 k,)``
    message words, point by point: ``x || y``, zeros for the identity."""
    return torch.where(is_id[None, :], 0, torch.cat([x, y])).T.reshape(-1)


def bytes_to_scalar_mod_r(bytes64: torch.Tensor) -> torch.Tensor:
    """Read ``(64, *batch)`` int64 bytes little-endian, reduce mod r ->
    ``(NW, *batch)`` canonical; one ``(64,)`` value gives ``(NW, 1)``."""
    if bytes64.dim() == 1:
        bytes64 = bytes64[:, None]
    pieces = bytes64[0::2] | (bytes64[1::2] << 8)  # (32, *batch) 16-bit
    return limb.reduce_512(pieces, FR)


def lazy_points_to_affine(pts: torch.Tensor):
    """``(3, NW, k)`` Montgomery projective points -> standard-form affine
    ``(x, y, is_id)``, ``(NW, k)`` coords.  One batched inversion and two
    products on the card's kernels; the Montgomery factors cancel in
    ``X/Z`` and ``Y/Z``.  (The name is the JAX package's, whose coordinates
    are lazy; here they are canonical.)"""
    x, y, z = pts[0], pts[1], pts[2]
    is_id = (z == 0).all(dim=0)
    z_safe = torch.where(is_id[None, :], limb.from_const(1, (1,), z.device), z).contiguous()
    zinv = kernels.mod_pow_static(z_safe, P - 2, FP)
    return kernels.vec_mul(x.contiguous(), zinv, FP), kernels.vec_mul(y.contiguous(), zinv, FP), is_id
