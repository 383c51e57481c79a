"""Keccak hash-chain Fiat-Shamir transcript, on the host.

The port's own copy of the JAX package's ``HashChainTranscript``, byte for
byte:

* ``state`` is 32 bytes; ``new(label)``: ``state = keccak256(pad_label(label))``
* ``append_message(l, m)``: ``state = keccak256(state || pad_label(l) || m)``
* ``challenge_bytes(l)``: ``state = keccak256(state || pad_label(l))``
* scalars absorb as 32 LE bytes, points as ``x || y`` LE felts (identity =
  64 zero bytes), challenges map to scalars through :func:`hash_to_scalar`.

The fused provers run the same chain on the card
(:mod:`.ops.transcript_t`) and write the final state back here; the
range-proof and IPP verifiers replay theirs there (:func:`replay`: every
byte a verifier absorbs is in the proof, so a replay is one launch).  The R1CS
prover draws its blindings from :meth:`HashChainTranscript.build_rng`, a
counter-mode keccak RNG keyed by the transcript, the witness and fresh
entropy.  :class:`MpcTranscript` wraps the transcript of a collaborative
prover's party and absorbs opened (public) values only.
"""

from __future__ import annotations

import secrets

import numpy as np

from .constants import R
from .ops.curve import StarkPoint, stark_point_to_transcript_bytes
from .ops.field import Scalar
from .ops.keccak import keccak256, keccak256_batch, pad_label
from .utils.errors import ProofError


def rangeproof_domain_steps(n: int, m: int) -> list:
    """The range proof's domain separator as transcript steps (label, message)."""
    return [(b"dom-sep", pad_label(b"rangeproof v1")), (b"n", int(n).to_bytes(8, "little")),
            (b"m", int(m).to_bytes(8, "little"))]


def innerproduct_domain_steps(n: int) -> list:
    """The inner-product argument's domain separator as transcript steps."""
    return [(b"dom-sep", pad_label(b"ipp v1")), (b"n", int(n).to_bytes(8, "little"))]


def scalar_message(scalar: Scalar) -> bytes:
    """A scalar as the transcript absorbs it: 32 LE bytes."""
    return bytes(reversed(scalar.to_bytes_be()))


def validated_point_message(point: StarkPoint) -> bytes:
    """``validate_and_append_point``'s message: the identity is refused."""
    if point.is_identity():
        raise ProofError("verification error: identity point in transcript")
    return stark_point_to_transcript_bytes(point)


def replay(transcripts: list, runs: list, device) -> list[list[int]]:
    """Replay on ``device`` each transcript's run of steps, ``(label,
    message bytes)`` absorbs and ``(label, None)`` challenges, as the host
    transcript would run them; every run takes the same labels and message
    lengths (one verification's, or a batch's).  One
    :func:`.ops.transcript_t.absorb_many` call for all (one
    ``keccak_transcript`` launch on the card, its plain version on the
    CPU) and one copy back: each transcript's state is set to its run's
    end, and each run's challenges come back as ints in ``[0, r)``."""
    import torch

    from .ops import transcript_t as tj
    from .ops.limb import NW, words_to_ints

    def shape(run):
        if any(msg is not None and len(msg) % 8 for _, msg in run):
            raise ValueError("replay: transcript messages are whole 64-bit words")
        return [(label, None if msg is None else len(msg) // 8) for label, msg in run]

    steps = shape(runs[0])
    if any(shape(run) != steps for run in runs[1:]):
        raise ValueError("replay: every run takes the same labels and message lengths")
    raw = b"".join(msg for run in runs for _, msg in run if msg is not None)
    msgs = np.frombuffer(raw, dtype="<u8").view(np.int64).reshape(len(runs), -1).copy()
    starts = np.stack([tj.state_words(t.state) for t in transcripts])
    state, u = tj.absorb_many(torch.as_tensor(starts, device=device), steps,
                              torch.as_tensor(msgs, device=device))
    k = len(transcripts)
    flat = (state if u is None else torch.cat([state.reshape(-1), u.reshape(-1)])).reshape(-1)
    host = flat.cpu().numpy()
    for t, words in zip(transcripts, host[: 4 * k].reshape(k, 4)):
        t.state = tj.state_bytes(words)
    return [words_to_ints(us) for us in host[4 * k :].reshape(k, NW, -1)]


def hash_to_scalar(low_u256: bytes) -> Scalar:
    """Uniform 32-byte buffer -> Scalar: extend to 64 bytes with one more
    keccak, read the concatenation little-endian, reduce mod ``R``."""
    high_u256 = keccak256(low_u256)
    return Scalar.from_be_bytes_mod_order(bytes(reversed(low_u256 + high_u256)))


class HashChainTranscript:
    """The keccak-chain transcript."""

    __slots__ = ("state",)

    def __init__(self, label: bytes = b""):
        self.state = keccak256(pad_label(label))

    def clone(self) -> "HashChainTranscript":
        t = HashChainTranscript.__new__(HashChainTranscript)
        t.state = self.state
        return t

    def append_message(self, label: bytes, message: bytes) -> None:
        self.state = keccak256(self.state + pad_label(label) + message)

    def append_u64(self, label: bytes, value: int) -> None:
        self.append_message(label, int(value).to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes) -> bytes:
        self.state = keccak256(self.state + pad_label(label))
        return self.state

    def rangeproof_domain_sep(self, n: int, m: int) -> None:
        for label, msg in rangeproof_domain_steps(n, m):
            self.append_message(label, msg)

    def innerproduct_domain_sep(self, n: int) -> None:
        for label, msg in innerproduct_domain_steps(n):
            self.append_message(label, msg)

    def r1cs_domain_sep(self) -> None:
        self.append_message(b"dom-sep", pad_label(b"r1cs v1"))

    def r1cs_1phase_domain_sep(self) -> None:
        self.append_message(b"dom-sep", pad_label(b"r1cs-1phase"))

    def r1cs_2phase_domain_sep(self) -> None:
        self.append_message(b"dom-sep", pad_label(b"r1cs-2phase"))

    def append_scalar(self, label: bytes, scalar: Scalar) -> None:
        self.append_message(label, scalar_message(scalar))

    def append_point(self, label: bytes, point: StarkPoint) -> None:
        self.append_message(label, stark_point_to_transcript_bytes(point))

    def validate_and_append_point(self, label: bytes, point: StarkPoint) -> None:
        """Reject the identity point, then absorb it."""
        self.append_message(label, validated_point_message(point))

    def challenge_scalar(self, label: bytes) -> Scalar:
        return hash_to_scalar(self.challenge_bytes(label))

    def build_rng(self) -> "TranscriptRngBuilder":
        """A builder for an RNG seeded by the transcript state."""
        return TranscriptRngBuilder(self.state)


class TranscriptRngBuilder:
    """Rekeys the transcript-seeded state with witness bytes, then with
    entropy (``finalize``)."""

    __slots__ = ("state",)

    def __init__(self, state: bytes):
        self.state = state

    def rekey_with_witness_bytes(self, label: bytes, witness: bytes) -> "TranscriptRngBuilder":
        self.state = keccak256(self.state + pad_label(label) + witness)
        return self

    def finalize(self, entropy: bytes | None = None) -> "TranscriptRng":
        """The RNG keyed by the state and 32 bytes of ``entropy``
        (``secrets`` when none is given)."""
        if entropy is None:
            entropy = secrets.token_bytes(32)
        return TranscriptRng(keccak256(self.state + entropy))


class TranscriptRng:
    """Counter-mode keccak RNG: block i is ``keccak256(state || i as u64 LE)``."""

    __slots__ = ("state", "counter")

    def __init__(self, state: bytes):
        self.state = state
        self.counter = 0

    def randbytes(self, n: int) -> bytes:
        """The next ``n`` bytes: whole blocks, all hashed in one batch."""
        nblocks = (n + 31) // 32
        if nblocks == 0:
            return b""
        ctr = np.arange(self.counter, self.counter + nblocks, dtype="<u8").view(np.uint8)
        msgs = np.concatenate([np.tile(np.frombuffer(self.state, np.uint8), (nblocks, 1)),
                               ctr.reshape(nblocks, 8)], axis=1)
        self.counter += nblocks
        return keccak256_batch(msgs).tobytes()[:n]

    def random_scalar(self) -> Scalar:
        return Scalar(int.from_bytes(self.randbytes(48), "big") % R)

    def random_scalars(self, k: int) -> list[Scalar]:
        raw = self.randbytes(48 * k)
        return [Scalar(int.from_bytes(raw[48 * i : 48 * (i + 1)], "big")) for i in range(k)]


class MpcTranscript:
    """The transcript of the collaborative prover: both parties run the same
    protocol in the same order and absorb the same opened values, so their
    challenges agree.  The wrapper only checks that what it absorbs is
    public (a ``Scalar`` or a ``StarkPoint``, never a share)."""

    __slots__ = ("inner",)

    def __init__(self, transcript: HashChainTranscript):
        self.inner = transcript

    def innerproduct_domain_sep(self, n: int) -> None:
        self.inner.innerproduct_domain_sep(n)

    def r1cs_domain_sep(self) -> None:
        self.inner.r1cs_domain_sep()

    def r1cs_1phase_domain_sep(self) -> None:
        self.inner.r1cs_1phase_domain_sep()

    def r1cs_2phase_domain_sep(self) -> None:
        self.inner.r1cs_2phase_domain_sep()

    def append_u64(self, label: bytes, value: int) -> None:
        self.inner.append_u64(label, value)

    def append_scalar(self, label: bytes, scalar: Scalar) -> None:
        if not isinstance(scalar, Scalar):
            raise TypeError("MpcTranscript absorbs opened (public) scalars only")
        self.inner.append_scalar(label, scalar)

    def append_point(self, label: bytes, point: StarkPoint) -> None:
        if not isinstance(point, StarkPoint):
            raise TypeError("MpcTranscript absorbs opened (public) points only")
        self.inner.append_point(label, point)

    def challenge_scalar(self, label: bytes) -> Scalar:
        return self.inner.challenge_scalar(label)
