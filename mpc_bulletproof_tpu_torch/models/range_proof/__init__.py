"""Aggregated 64-bit range proofs: the proof type, its codec, and the prover
entry point, which runs the whole protocol on the card (:mod:`.fused_device`).

Proof layout: ``{A, S, T_1, T_2, t(x), ~t(x), ~e}`` followed by the IPP,
``(9 + 2 log2(n m)) * 32`` bytes; the same bytes as the JAX package's
``RangeProof``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...constants import SCALAR_BYTES, STARK_POINT_BYTES
from ...generators import BulletproofGens, PedersenGens
from ...ops.curve import StarkPoint
from ...ops.field import Scalar
from ...transcript import HashChainTranscript
from ...utils.errors import FormatError
from ..inner_product import InnerProductProof


@dataclass
class RangeProof:
    A: StarkPoint
    S: StarkPoint
    T_1: StarkPoint
    T_2: StarkPoint
    t_x: Scalar
    t_x_blinding: Scalar
    e_blinding: Scalar
    ipp_proof: InnerProductProof

    @staticmethod
    def prove_multiple(
        bp_gens: BulletproofGens,
        pc_gens: PedersenGens,
        transcript: HashChainTranscript,
        values: list[int],
        blindings: list[Scalar],
        n: int,
        *,
        device="cuda",
        rng_bytes=None,
    ) -> tuple["RangeProof", list[StarkPoint]]:
        """Aggregated proof that every value is in ``[0, 2^n)``; returns the
        proof and the value commitments.  Runs on the card unless
        ``device="cpu"``; raises when asked for a card that is not there.
        ``rng_bytes(k)`` optionally supplies the blinding stream."""
        from .fused_device import prove_multiple_device

        return prove_multiple_device(bp_gens, pc_gens, transcript, values, blindings, n,
                                     device=device, rng_bytes=rng_bytes)

    def serialized_size(self) -> int:
        return 4 * STARK_POINT_BYTES + 3 * SCALAR_BYTES + self.ipp_proof.serialized_size()

    def to_bytes(self) -> bytes:
        buf = bytearray()
        for p in (self.A, self.S, self.T_1, self.T_2):
            buf += p.to_bytes()
        buf += self.t_x.to_bytes_be()
        buf += self.t_x_blinding.to_bytes_be()
        buf += self.e_blinding.to_bytes_be()
        buf += self.ipp_proof.to_bytes()
        return bytes(buf)

    @staticmethod
    def from_bytes(data: bytes) -> "RangeProof":
        if len(data) % 32 != 0 or len(data) < 7 * 32:
            raise FormatError("bad range proof length")
        try:
            A, S, T_1, T_2 = (StarkPoint.from_bytes(data[32 * i : 32 * i + 32]) for i in range(4))
        except ValueError as exc:
            raise FormatError(str(exc)) from exc
        t_x = Scalar.from_be_bytes_mod_order(data[128:160])
        t_x_blinding = Scalar.from_be_bytes_mod_order(data[160:192])
        e_blinding = Scalar.from_be_bytes_mod_order(data[192:224])
        ipp = InnerProductProof.from_bytes(data[224:])
        return RangeProof(A, S, T_1, T_2, t_x, t_x_blinding, e_blinding, ipp)

    def __eq__(self, other):
        return isinstance(other, RangeProof) and self.to_bytes() == other.to_bytes()
