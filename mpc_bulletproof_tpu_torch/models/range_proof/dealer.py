"""The dealer side of the aggregated range proof's party/dealer protocol.

The dealer owns the Fiat-Shamir transcript: it absorbs the parties'
commitments, issues the challenges, audits the proof shares and assembles
the :class:`~.RangeProof`, whose inner-product argument it runs over the
concatenated l and r vectors.  The port's copy of the JAX package's
``models/range_proof/dealer.py``:

    Dealer.new -> DealerAwaitingBitCommitments -> DealerAwaitingPolyCommitments
               -> DealerAwaitingProofShares -> RangeProof

The sums of A, S, T_1 and T_2 are host point additions.  On ``device``
(the card unless the caller asks for the CPU) run the inner-product
argument, over the cached generator tensor from a width of 32 on
(:meth:`...inner_product.InnerProductProof.create`), and each share's
audit, one MSM of 2n + 7 points over party j's generators
(:func:`.party.party_gens_msm`).  The fused prover (:mod:`.fused_device`)
runs only :meth:`Dealer.new`, for its checks and the domain separator.
"""

from __future__ import annotations

from ...generators import BulletproofGens, PedersenGens, device_gens
from ...ops.backend import _DEVICE_MIN
from ...ops.curve import StarkPoint
from ...ops.field import Scalar, inner_product, scalar_powers, sum_of_powers
from ...transcript import HashChainTranscript
from ...utils.device import resolve_device
from ...utils.errors import MPCError
from ..inner_product import InnerProductProof
from .messages import BitChallenge, BitCommitment, PolyChallenge, PolyCommitment, ProofShare
from .party import party_gens_msm


class Dealer:
    @staticmethod
    def new(bp_gens: BulletproofGens, pc_gens: PedersenGens, transcript: HashChainTranscript,
            n: int, m: int, *, device="cuda") -> "DealerAwaitingBitCommitments":
        """Validate ``(n, m)`` against the generators, then absorb the
        range-proof domain separator.  A card asked for and missing raises."""
        if n <= 0 or (n & (n - 1)):
            raise MPCError(f"invalid bitsize {n}")
        if m <= 0 or (m & (m - 1)):
            raise MPCError(f"invalid aggregation size {m}")
        if bp_gens.gens_capacity < n:
            raise MPCError("generator capacity too small for bitsize")
        if bp_gens.party_capacity < m:
            raise MPCError("generator party capacity too small")
        dev = resolve_device(device)
        transcript.rangeproof_domain_sep(n, m)
        return DealerAwaitingBitCommitments(bp_gens, pc_gens, transcript, n, m, dev)


class DealerAwaitingBitCommitments:
    def __init__(self, bp_gens, pc_gens, transcript, n, m, device):
        self.bp_gens = bp_gens
        self.pc_gens = pc_gens
        self.transcript = transcript
        self.n = n
        self.m = m
        self.device = device

    def receive_bit_commitments(self, bit_commitments: list[BitCommitment]
                                ) -> tuple["DealerAwaitingPolyCommitments", BitChallenge]:
        if len(bit_commitments) != self.m:
            raise MPCError("wrong number of bit commitments")
        t = self.transcript
        for vc in bit_commitments:
            t.append_point(b"V", vc.V_j)
        A = StarkPoint.identity()
        S = StarkPoint.identity()
        for vc in bit_commitments:
            A = A + vc.A_j
            S = S + vc.S_j
        t.append_point(b"A", A)
        t.append_point(b"S", S)
        challenge = BitChallenge(t.challenge_scalar(b"y"), t.challenge_scalar(b"z"))
        return DealerAwaitingPolyCommitments(self, bit_commitments, A, S, challenge), challenge


class DealerAwaitingPolyCommitments:
    def __init__(self, base: DealerAwaitingBitCommitments, bit_commitments, A, S, bit_challenge):
        self.bp_gens = base.bp_gens
        self.pc_gens = base.pc_gens
        self.transcript = base.transcript
        self.n = base.n
        self.m = base.m
        self.device = base.device
        self.bit_commitments = bit_commitments
        self.A = A
        self.S = S
        self.bit_challenge = bit_challenge

    def receive_poly_commitments(self, poly_commitments: list[PolyCommitment]
                                 ) -> tuple["DealerAwaitingProofShares", PolyChallenge]:
        if len(poly_commitments) != self.m:
            raise MPCError("wrong number of poly commitments")
        t = self.transcript
        T_1 = StarkPoint.identity()
        T_2 = StarkPoint.identity()
        for pc in poly_commitments:
            T_1 = T_1 + pc.T_1_j
            T_2 = T_2 + pc.T_2_j
        t.append_point(b"T_1", T_1)
        t.append_point(b"T_2", T_2)
        challenge = PolyChallenge(t.challenge_scalar(b"x"))
        return DealerAwaitingProofShares(self, poly_commitments, T_1, T_2, challenge), challenge


class DealerAwaitingProofShares:
    def __init__(self, base: DealerAwaitingPolyCommitments, poly_commitments, T_1, T_2, poly_challenge):
        self.bp_gens = base.bp_gens
        self.pc_gens = base.pc_gens
        self.transcript = base.transcript
        self.n = base.n
        self.m = base.m
        self.device = base.device
        self.bit_commitments = base.bit_commitments
        self.bit_challenge = base.bit_challenge
        self.A = base.A
        self.S = base.S
        self.poly_commitments = poly_commitments
        self.T_1 = T_1
        self.T_2 = T_2
        self.poly_challenge = poly_challenge

    def receive_shares(self, proof_shares: list[ProofShare]):
        """Audit each share, then assemble the proof; raises
        :class:`MPCError` naming the parties whose shares are malformed."""
        bad = [j for j, ps in enumerate(proof_shares) if not self._share_is_valid(j, ps)]
        if bad:
            raise MPCError(f"malformed proof shares from parties {bad}")
        return self._assemble_shares(proof_shares)

    def receive_trusted_shares(self, proof_shares: list[ProofShare]):
        """Assemble the proof without auditing the shares (honest parties)."""
        return self._assemble_shares(proof_shares)

    def _assemble_shares(self, proof_shares: list[ProofShare]):
        from . import RangeProof

        if len(proof_shares) != self.m:
            raise MPCError("wrong number of proof shares")
        t = self.transcript
        n, m = self.n, self.m
        t_x = Scalar(0)
        t_x_blinding = Scalar(0)
        e_blinding = Scalar(0)
        for ps in proof_shares:
            t_x += ps.t_x
            t_x_blinding += ps.t_x_blinding
            e_blinding += ps.e_blinding
        t.append_scalar(b"t_x", t_x)
        t.append_scalar(b"t_x_blinding", t_x_blinding)
        t.append_scalar(b"e_blinding", e_blinding)
        w = t.challenge_scalar(b"w")
        Q = w * self.pc_gens.B

        nm = n * m
        G_factors = [Scalar(1)] * nm
        H_factors = scalar_powers(self.bit_challenge.y.inverse(), nm)
        l_vec = [s for ps in proof_shares for s in ps.l_vec]
        r_vec = [s for ps in proof_shares for s in ps.r_vec]
        if nm >= _DEVICE_MIN:
            G, H = device_gens(self.bp_gens, n, m, self.device)
        else:
            G, H = self.bp_gens.G(n, m), self.bp_gens.H(n, m)
        ipp_proof = InnerProductProof.create(t, Q, G_factors, H_factors, G, H, l_vec, r_vec,
                                             device=self.device)
        return RangeProof(A=self.A, S=self.S, T_1=self.T_1, T_2=self.T_2, t_x=t_x,
                          t_x_blinding=t_x_blinding, e_blinding=e_blinding, ipp_proof=ipp_proof)

    def _share_is_valid(self, j: int, ps: ProofShare) -> bool:
        """Party ``j``'s share against its commitments: t = <l, r>, then the
        t-polynomial's and the l/r commitments' equations in one MSM, the
        second weighted by a random c."""
        n = self.n
        y, z = self.bit_challenge.y, self.bit_challenge.z
        x = self.poly_challenge.x
        if len(ps.l_vec) != n or len(ps.r_vec) != n:
            return False
        if inner_product(ps.l_vec, ps.r_vec) != ps.t_x:
            return False
        bc = self.bit_commitments[j]
        pcm = self.poly_commitments[j]
        c = Scalar.random()

        # delta_(j)(y, z) = (z - z^2) <1, y^n y^(jn)> - z^(j + 3) <1, 2^n>
        offset_y = Scalar(pow(y.value, j * n, Scalar.MODULUS))
        zz = z * z
        z_j = Scalar(pow(z.value, j, Scalar.MODULUS))
        delta = (z - zz) * sum_of_powers(y, n) * offset_y - z * zz * z_j * sum_of_powers(Scalar(2), n)

        y_inv = y.inverse()
        offset_y_inv = Scalar(pow(y_inv.value, j * n, Scalar.MODULUS))
        y_inv_pows = scalar_powers(y_inv, n)
        g_scalars = [-z - l_i for l_i in ps.l_vec]
        h_scalars = []
        exp_2 = Scalar(1)
        for i in range(n):
            h_scalars.append(z + offset_y_inv * y_inv_pows[i] * (zz * z_j * exp_2 - ps.r_vec[i]))
            exp_2 = exp_2 + exp_2

        scalars = ([Scalar(1), x, -ps.e_blinding - c * ps.t_x_blinding, c * (delta - ps.t_x),
                    c * zz * z_j, c * x, c * x * x] + g_scalars + h_scalars)
        lead = [bc.A_j, bc.S_j, self.pc_gens.B_blinding, self.pc_gens.B, bc.V_j, pcm.T_1_j, pcm.T_2_j]
        return party_gens_msm(self.bp_gens, scalars, lead, n, j, self.device).is_identity()
