"""R1CS proof object and byte codec, the same bytes as the JAX package's.

Layout: 1 version byte (one-phase = 0 / two-phase = 1), then 8 or 11
compressed points ``A_I1, A_O1, S1, (A_I2, A_O2, S2), T_1, T_3..T_6``, three
scalars ``t_x, t_x_blinding, e_blinding``, then the IPP bytes.  The phase-2
commitments are elided when they are all the identity (proof.rs:82-123).
"""

from __future__ import annotations

from dataclasses import dataclass

from ...constants import SCALAR_BYTES, STARK_POINT_BYTES
from ...ops.curve import StarkPoint
from ...ops.field import Scalar
from ...utils.errors import FormatError
from ..inner_product import InnerProductProof

ONE_PHASE_COMMITMENTS = 0
TWO_PHASE_COMMITMENTS = 1


@dataclass
class R1CSProof:
    A_I1: StarkPoint
    A_O1: StarkPoint
    S1: StarkPoint
    A_I2: StarkPoint
    A_O2: StarkPoint
    S2: StarkPoint
    T_1: StarkPoint
    T_3: StarkPoint
    T_4: StarkPoint
    T_5: StarkPoint
    T_6: StarkPoint
    t_x: Scalar
    t_x_blinding: Scalar
    e_blinding: Scalar
    ipp_proof: InnerProductProof

    def missing_phase2_commitments(self) -> bool:
        return (
            self.A_I2.is_identity()
            and self.A_O2.is_identity()
            and self.S2.is_identity()
        )

    def serialized_size(self) -> int:
        elements = 11 if self.missing_phase2_commitments() else 14
        return 1 + elements * 32 + self.ipp_proof.serialized_size()

    def to_bytes(self) -> bytes:
        buf = bytearray()
        if self.missing_phase2_commitments():
            buf.append(ONE_PHASE_COMMITMENTS)
            pts = [self.A_I1, self.A_O1, self.S1]
        else:
            buf.append(TWO_PHASE_COMMITMENTS)
            pts = [self.A_I1, self.A_O1, self.S1, self.A_I2, self.A_O2, self.S2]
        for p in pts + [self.T_1, self.T_3, self.T_4, self.T_5, self.T_6]:
            buf += p.to_bytes()
        buf += self.t_x.to_bytes_be()
        buf += self.t_x_blinding.to_bytes_be()
        buf += self.e_blinding.to_bytes_be()
        buf += self.ipp_proof.to_bytes()
        return bytes(buf)

    @staticmethod
    def from_bytes(data: bytes) -> "R1CSProof":
        if not data:
            raise FormatError("empty R1CS proof")
        version = data[0]
        rest = data[1:]
        if len(rest) % 32 != 0:
            raise FormatError("R1CS proof not 32-byte aligned")
        if version == ONE_PHASE_COMMITMENTS:
            minlength = 11 * 32
        elif version == TWO_PHASE_COMMITMENTS:
            minlength = 14 * 32
        else:
            raise FormatError("unknown R1CS proof version")
        if len(rest) < minlength:
            raise FormatError("R1CS proof too short")

        pos = 0

        def read_point() -> StarkPoint:
            nonlocal pos
            try:
                p = StarkPoint.from_bytes(rest[pos : pos + STARK_POINT_BYTES])
            except ValueError as exc:
                raise FormatError(str(exc)) from exc
            pos += STARK_POINT_BYTES
            return p

        def read_scalar() -> Scalar:
            nonlocal pos
            s = Scalar.from_be_bytes_mod_order(rest[pos : pos + SCALAR_BYTES])
            pos += SCALAR_BYTES
            return s

        A_I1, A_O1, S1 = read_point(), read_point(), read_point()
        if version == ONE_PHASE_COMMITMENTS:
            A_I2 = A_O2 = S2 = StarkPoint.identity()
        else:
            A_I2, A_O2, S2 = read_point(), read_point(), read_point()
        T_1, T_3, T_4, T_5, T_6 = (read_point() for _ in range(5))
        t_x, t_x_blinding, e_blinding = read_scalar(), read_scalar(), read_scalar()
        ipp = InnerProductProof.from_bytes(rest[pos:])
        return R1CSProof(
            A_I1, A_O1, S1, A_I2, A_O2, S2, T_1, T_3, T_4, T_5, T_6,
            t_x, t_x_blinding, e_blinding, ipp,
        )

    def __eq__(self, other):
        return isinstance(other, R1CSProof) and self.to_bytes() == other.to_bytes()
