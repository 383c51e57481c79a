"""The partially shared R1CS proof of the collaborative prover.

Every group element was opened during the protocol (the transcript needs
them public); only the IPP tail ``a, b`` is still shared.  :meth:`open`
makes the final MAC-checked opening and gives the plain
:class:`~..r1cs.proof.R1CSProof`, which the single-prover verifier checks.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...ops.curve import StarkPoint
from ...ops.field import Scalar
from ..r1cs.proof import R1CSProof
from .mpc_inner_product import SharedInnerProductProof


@dataclass
class PartiallySharedR1CSProof:
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
    ipp_proof: SharedInnerProductProof

    def open(self) -> R1CSProof:
        """Open the shared IPP tail (MAC-checked) and assemble the proof."""
        return R1CSProof(
            self.A_I1, self.A_O1, self.S1, self.A_I2, self.A_O2, self.S2,
            self.T_1, self.T_3, self.T_4, self.T_5, self.T_6,
            self.t_x, self.t_x_blinding, self.e_blinding, self.ipp_proof.open(),
        )
