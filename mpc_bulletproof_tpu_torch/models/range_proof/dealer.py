"""The dealer's entry checks of the aggregated range proof.

Only the entry of the JAX package's party/dealer state machine is ported:
the size checks and the transcript's domain separator, which the fused
prover runs before it draws anything.  The rest of the protocol runs inside
:mod:`.fused_device`.
"""

from __future__ import annotations

from ...generators import BulletproofGens, PedersenGens
from ...transcript import HashChainTranscript
from ...utils.errors import MPCError


class Dealer:
    @staticmethod
    def new(bp_gens: BulletproofGens, pc_gens: PedersenGens,
            transcript: HashChainTranscript, n: int, m: int) -> None:
        """Validate ``(n, m)`` against the generators, then absorb the
        range-proof domain separator."""
        if n <= 0 or (n & (n - 1)):
            raise MPCError(f"invalid bitsize {n}")
        if m <= 0 or (m & (m - 1)):
            raise MPCError(f"invalid aggregation size {m}")
        if bp_gens.gens_capacity < n:
            raise MPCError("generator capacity too small for bitsize")
        if bp_gens.party_capacity < m:
            raise MPCError("generator party capacity too small")
        transcript.rangeproof_domain_sep(n, m)
