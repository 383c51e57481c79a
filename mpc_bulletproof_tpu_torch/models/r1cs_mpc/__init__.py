"""Collaborative (2-party MPC) R1CS proofs.

The witness is additively secret-shared between two parties; the proof is
made over the MPC fabric (:mod:`...parallel.fabric`) as a
:class:`PartiallySharedR1CSProof`, which opens to a plain
:class:`~..r1cs.R1CSProof` that the single-prover verifier accepts.  The
port's copy of the JAX package's ``models/r1cs_mpc``.
"""

from .authenticated_poly import AuthenticatedPoly6, AuthenticatedVecPoly3  # noqa: F401
from .mpc_constraint_system import (  # noqa: F401
    MpcConstraintSystem,
    MpcRandomizableConstraintSystem,
    MpcRandomizedConstraintSystem,
)
from .mpc_inner_product import SharedInnerProductProof  # noqa: F401
from .mpc_linear_combination import MpcLinearCombination, MpcVariable  # noqa: F401
from .mpc_prover import MpcProver, RandomizingMpcProver  # noqa: F401
from .proof import PartiallySharedR1CSProof  # noqa: F401
