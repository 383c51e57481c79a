"""Keccak hash-chain Fiat-Shamir transcript, on the host.

The port's own copy of the JAX package's ``HashChainTranscript``, byte for
byte:

* ``state`` is 32 bytes; ``new(label)``: ``state = keccak256(pad_label(label))``
* ``append_message(l, m)``: ``state = keccak256(state || pad_label(l) || m)``
* ``challenge_bytes(l)``: ``state = keccak256(state || pad_label(l))``
* scalars absorb as 32 LE bytes, points as ``x || y`` LE felts (identity =
  64 zero bytes), challenges map to scalars through :func:`hash_to_scalar`.

The fused prover runs the same chain on the card
(:mod:`.ops.transcript_t`) and writes the final state back here.
"""

from __future__ import annotations

from .ops.curve import StarkPoint, stark_point_to_transcript_bytes
from .ops.field import Scalar
from .ops.keccak import keccak256, pad_label
from .utils.errors import ProofError


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

    def append_message(self, label: bytes, message: bytes) -> None:
        self.state = keccak256(self.state + pad_label(label) + message)

    def append_u64(self, label: bytes, value: int) -> None:
        self.append_message(label, int(value).to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes) -> bytes:
        self.state = keccak256(self.state + pad_label(label))
        return self.state

    def rangeproof_domain_sep(self, n: int, m: int) -> None:
        self.append_message(b"dom-sep", pad_label(b"rangeproof v1"))
        self.append_u64(b"n", n)
        self.append_u64(b"m", m)

    def innerproduct_domain_sep(self, n: int) -> None:
        self.append_message(b"dom-sep", pad_label(b"ipp v1"))
        self.append_u64(b"n", n)

    def append_scalar(self, label: bytes, scalar: Scalar) -> None:
        self.append_message(label, bytes(reversed(scalar.to_bytes_be())))

    def append_point(self, label: bytes, point: StarkPoint) -> None:
        self.append_message(label, stark_point_to_transcript_bytes(point))

    def validate_and_append_point(self, label: bytes, point: StarkPoint) -> None:
        """Reject the identity point, then absorb it."""
        if point.is_identity():
            raise ProofError("verification error: identity point in transcript")
        self.append_point(label, point)

    def challenge_scalar(self, label: bytes) -> Scalar:
        return hash_to_scalar(self.challenge_bytes(label))
