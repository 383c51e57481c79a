"""mpc_bulletproof_tpu_torch: the PyTorch and CUDA port of mpc_bulletproof_tpu.

The aggregated range prover, the R1CS constraint-system prover and their
verifiers run on one NVIDIA Hopper card (H100): plain tensor code in
PyTorch, the point and inverse work in hand-written CUDA kernels
(``csrc/``, built with ``nvcc`` at first use).  Proofs are byte for byte the
JAX package's.  The package imports torch and numpy, never jax and
nothing of mpc_bulletproof_tpu; it keeps its own copy of the host layer
(constants, scalars, points, keccak, transcript, generators).
"""

from .generators import BulletproofGens, BulletproofGensShare, PedersenGens
from .models.inner_product import InnerProductProof
from .models.r1cs import LinearCombination, Prover, R1CSProof, Variable, Verifier
from .models.range_proof import RangeProof
from .ops.curve import StarkPoint
from .ops.field import Scalar
from .transcript import HashChainTranscript
from .utils.errors import VerificationError

__version__ = "0.1.0"

__all__ = [
    "BulletproofGens",
    "BulletproofGensShare",
    "HashChainTranscript",
    "InnerProductProof",
    "LinearCombination",
    "PedersenGens",
    "Prover",
    "R1CSProof",
    "RangeProof",
    "Scalar",
    "StarkPoint",
    "Variable",
    "VerificationError",
    "Verifier",
]
