"""Single-prover R1CS constraint-system proofs: gadget DSL, prover, verifier
and proof codec, the port's copy of the JAX package's ``models/r1cs``."""

from .constraint_system import (  # noqa: F401
    CircuitWeights,
    ConstraintSystem,
    RandomizableConstraintSystem,
    RandomizedConstraintSystem,
    SparseReducedMatrix,
    SparseWeightRow,
)
from .linear_combination import LinearCombination, Variable  # noqa: F401
from .proof import R1CSProof  # noqa: F401
from .prover import Prover, RandomizingProver  # noqa: F401
from .verifier import RandomizingVerifier, Verifier  # noqa: F401
