"""mpc_bulletproof_tpu_torch: the PyTorch and CUDA port of mpc_bulletproof_tpu.

The aggregated range prover, the R1CS constraint-system prover, the
collaborative (2-party MPC) R1CS prover and the verifiers run on one
NVIDIA Hopper card (H100): plain tensor code in
PyTorch, the point and inverse work in hand-written CUDA kernels
(``csrc/``, built with ``nvcc`` at first use).  Proofs are byte for byte the
JAX package's.  The package imports torch and numpy, never jax and
nothing of mpc_bulletproof_tpu; it keeps its own copy of the host layer
(constants, scalars, points, keccak, transcript, generators).
"""

from .constants import P, R, SCALAR_BYTES, STARK_POINT_BYTES
from .generators import BulletproofGens, BulletproofGensShare, PedersenGens
from .models.inner_product import InnerProductProof
from .models.r1cs import LinearCombination, Prover, R1CSProof, Variable, Verifier
from .models.r1cs_mpc import MpcProver, PartiallySharedR1CSProof, SharedInnerProductProof
from .models.range_proof import RangeProof
from .ops.curve import StarkPoint, random_point
from .ops.field import Scalar, inner_product
from .parallel.beaver import PartyIdBeaverSource
from .parallel.fabric import MpcFabric
from .parallel.network import make_local_pair
from .transcript import HashChainTranscript, MpcTranscript, hash_to_scalar
from .utils import errors
from .utils.errors import AuthenticationError, VerificationError

__version__ = "0.1.0"

__all__ = [
    "P",
    "R",
    "SCALAR_BYTES",
    "STARK_POINT_BYTES",
    "AuthenticationError",
    "BulletproofGens",
    "BulletproofGensShare",
    "HashChainTranscript",
    "InnerProductProof",
    "LinearCombination",
    "MpcFabric",
    "MpcProver",
    "MpcTranscript",
    "PartiallySharedR1CSProof",
    "PartyIdBeaverSource",
    "PedersenGens",
    "Prover",
    "R1CSProof",
    "RangeProof",
    "Scalar",
    "SharedInnerProductProof",
    "StarkPoint",
    "Variable",
    "VerificationError",
    "Verifier",
    "errors",
    "hash_to_scalar",
    "inner_product",
    "make_local_pair",
    "random_point",
]
