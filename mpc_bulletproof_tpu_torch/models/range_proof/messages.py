"""The messages between the parties and the dealer of the aggregated range
proof: parties send ``BitCommitment``, ``PolyCommitment`` and
``ProofShare``; the dealer answers with ``BitChallenge`` and
``PolyChallenge``.  The port's copy of the JAX package's
``models/range_proof/messages.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...ops.curve import StarkPoint
from ...ops.field import Scalar


@dataclass
class BitCommitment:
    V_j: StarkPoint
    A_j: StarkPoint
    S_j: StarkPoint


@dataclass
class BitChallenge:
    y: Scalar
    z: Scalar


@dataclass
class PolyCommitment:
    T_1_j: StarkPoint
    T_2_j: StarkPoint


@dataclass
class PolyChallenge:
    x: Scalar


@dataclass
class ProofShare:
    t_x: Scalar
    t_x_blinding: Scalar
    e_blinding: Scalar
    l_vec: list[Scalar]
    r_vec: list[Scalar]
