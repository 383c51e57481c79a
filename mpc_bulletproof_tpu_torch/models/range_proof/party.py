"""The party side of the aggregated range proof's party/dealer protocol.

Each party holds one secret value and walks the states

    Party -> PartyAwaitingPosition -> PartyAwaitingBitChallenge
          -> PartyAwaitingPolyChallenge -> ProofShare

Each state is used once: applying it twice raises :class:`MPCError`.  The
port's copy of the JAX package's ``models/range_proof/party.py``, with the
same checks and the same draws from ``rng_bytes``: the a and s blindings,
s_L and s_R when a position is assigned, then the t_1 and t_2 blindings
when the bit challenge is applied (48 bytes a scalar).  Parties run in
order j = 0..m-1 on one stream therefore draw what the fused prover
(:mod:`.fused_device`) draws, and the dealer assembles its proof.

A_j and S_j are MSMs of 2n + 1 points over party j's generators and the
blinding base, on ``device`` from 32 points on
(:func:`party_gens_msm`, the generators from the device cache); V_j,
T_1 and T_2 are two-point commitments on the host.
"""

from __future__ import annotations

import secrets

from ...generators import BulletproofGens, PedersenGens
from ...ops import backend
from ...ops.field import Scalar
from ...ops.poly import VecPoly1
from ...utils.device import resolve_device
from ...utils.errors import MPCError
from .messages import BitChallenge, BitCommitment, PolyChallenge, PolyCommitment, ProofShare


def party_gens_msm(bp_gens: BulletproofGens, scalars, lead, n: int, j: int, device):
    """``sum scalars * (lead + G_j(n) + H_j(n))`` over party ``j``'s
    generators: the columns ``j n .. (j + 1) n`` of the aggregated vectors
    of all ``bp_gens.party_capacity`` parties (one cached device tensor
    serves every party), by :func:`...ops.backend.gens_msm`."""
    return backend.gens_msm(bp_gens, scalars, lead, n, bp_gens.party_capacity, lo=j * n,
                            hi=(j + 1) * n, device=device)


class Party:
    """Entry point: bind a value and its blinding to generators of width ``n``."""

    @staticmethod
    def new(bp_gens: BulletproofGens, pc_gens: PedersenGens, v: int, v_blinding: Scalar, n: int,
            *, device="cuda") -> "PartyAwaitingPosition":
        """The party's MSMs run on ``device`` (the card unless the caller
        asks for the CPU); a card asked for and missing raises."""
        if not (n > 0 and (n & (n - 1)) == 0):
            raise MPCError(f"invalid bitsize {n}")
        if bp_gens.gens_capacity < n:
            raise MPCError("generators capacity too small for bitsize")
        if not 0 <= v < (1 << n):
            raise MPCError("value out of range for bitsize")
        return PartyAwaitingPosition(bp_gens, pc_gens, int(v), v_blinding, n, resolve_device(device))


class PartyAwaitingPosition:
    def __init__(self, bp_gens, pc_gens, v, v_blinding, n, device):
        self.bp_gens = bp_gens
        self.pc_gens = pc_gens
        self.v = v
        self.v_blinding = v_blinding
        self.n = n
        self.device = device
        self._used = False

    def assign_position(self, j: int, rng_bytes=secrets.token_bytes
                        ) -> tuple["PartyAwaitingBitChallenge", BitCommitment]:
        """V, A and S for aggregation slot ``j``."""
        if self._used:
            raise MPCError("party position already assigned")
        self._used = True
        if self.bp_gens.party_capacity <= j:
            raise MPCError("invalid party index for generator capacity")
        n = self.n
        rand = lambda: Scalar(int.from_bytes(rng_bytes(48), "big"))
        a_blinding = rand()
        s_blinding = rand()
        s_L = [rand() for _ in range(n)]
        s_R = [rand() for _ in range(n)]

        V_j = self.pc_gens.commit(Scalar(self.v), self.v_blinding)
        # A = <a_L, G> + <a_R, H> + a_blinding B~ with a_L the bits of v and
        # a_R = a_L - 1; S = <s_L, G> + <s_R, H> + s_blinding B~
        bits = [(self.v >> i) & 1 for i in range(n)]
        lead = [self.pc_gens.B_blinding]
        A_j = party_gens_msm(self.bp_gens, [a_blinding] + [Scalar(b) for b in bits]
                             + [Scalar(b - 1) for b in bits], lead, n, j, self.device)
        S_j = party_gens_msm(self.bp_gens, [s_blinding] + s_L + s_R, lead, n, j, self.device)

        next_state = PartyAwaitingBitChallenge(n, self.v, self.v_blinding, j, self.pc_gens, a_blinding,
                                               s_blinding, s_L, s_R, rng_bytes)
        return next_state, BitCommitment(V_j, A_j, S_j)


class PartyAwaitingBitChallenge:
    def __init__(self, n, v, v_blinding, j, pc_gens, a_blinding, s_blinding, s_L, s_R, rng_bytes):
        self.n = n
        self.v = v
        self.v_blinding = v_blinding
        self.j = j
        self.pc_gens = pc_gens
        self.a_blinding = a_blinding
        self.s_blinding = s_blinding
        self.s_L = s_L
        self.s_R = s_R
        self._rng_bytes = rng_bytes
        self._used = False

    def apply_challenge(self, vc: BitChallenge) -> tuple["PartyAwaitingPolyChallenge", PolyCommitment]:
        if self._used:
            raise MPCError("bit challenge already applied")
        self._used = True
        n, j = self.n, self.j
        y, z = vc.y, vc.z
        offset_y = Scalar(pow(y.value, j * n, Scalar.MODULUS))
        offset_z = Scalar(pow(z.value, j, Scalar.MODULUS))
        zz = z * z

        # l(x) = (a_L - z 1) + s_L x;  r(x) = y^n_(j) o (a_R + z 1)
        #        + z^2 z^j 2^n + (y^n_(j) o s_R) x
        l_poly = VecPoly1.zero(n)
        r_poly = VecPoly1.zero(n)
        exp_y = offset_y
        exp_2 = Scalar(1)
        for i in range(n):
            a_L_i = Scalar((self.v >> i) & 1)
            a_R_i = a_L_i - Scalar(1)
            l_poly.c0[i] = a_L_i - z
            l_poly.c1[i] = self.s_L[i]
            r_poly.c0[i] = exp_y * (a_R_i + z) + zz * offset_z * exp_2
            r_poly.c1[i] = exp_y * self.s_R[i]
            exp_y = exp_y * y
            exp_2 = exp_2 + exp_2
        t_poly = l_poly.inner_product(r_poly)

        rand = lambda: Scalar(int.from_bytes(self._rng_bytes(48), "big"))
        t_1_blinding = rand()
        t_2_blinding = rand()
        T_1 = self.pc_gens.commit(t_poly.t1, t_1_blinding)
        T_2 = self.pc_gens.commit(t_poly.t2, t_2_blinding)
        next_state = PartyAwaitingPolyChallenge(self.v_blinding, self.a_blinding, self.s_blinding,
                                                zz * offset_z, l_poly, r_poly, t_poly, t_1_blinding,
                                                t_2_blinding)
        return next_state, PolyCommitment(T_1, T_2)


class PartyAwaitingPolyChallenge:
    def __init__(self, v_blinding, a_blinding, s_blinding, offset_zz, l_poly, r_poly, t_poly,
                 t_1_blinding, t_2_blinding):
        self.v_blinding = v_blinding
        self.a_blinding = a_blinding
        self.s_blinding = s_blinding
        self.offset_zz = offset_zz
        self.l_poly = l_poly
        self.r_poly = r_poly
        self.t_poly = t_poly
        self.t_1_blinding = t_1_blinding
        self.t_2_blinding = t_2_blinding
        self._used = False

    def apply_challenge(self, pc: PolyChallenge) -> ProofShare:
        if self._used:
            raise MPCError("poly challenge already applied")
        self._used = True
        x = pc.x
        if x.is_zero():
            raise MPCError("maliciously formed zero challenge")
        # t_blinding(x) = z^2 z^j v_blinding + x t1_b + x^2 t2_b
        t_x_blinding = self.offset_zz * self.v_blinding + x * (self.t_1_blinding + x * self.t_2_blinding)
        return ProofShare(t_x=self.t_poly.eval(x), t_x_blinding=t_x_blinding,
                          e_blinding=self.a_blinding + x * self.s_blinding,
                          l_vec=self.l_poly.eval(x), r_vec=self.r_poly.eval(x))
