"""The collaborative (2-party MPC) R1CS prover.

One instance runs per party; both run the same protocol sequence over the
shared fabric.  The pipeline is the single prover's
(:mod:`..r1cs.prover`), with communication where shares must meet: share
distribution in ``commit``, a Beaver round per multiplier, the phase-1 and
phase-2 point openings, one Beaver round for the whole t-polynomial
(:class:`.authenticated_poly.AuthenticatedVecPoly3`), the T-commitment
opening, the batched opening of ``t_x``, its blinding and ``e_blinding``,
and two point openings per IPP round (:class:`.SharedInnerProductProof`).
The blindings come from the fabric's pre-processing source.

The phase MSMs run through :func:`...ops.backend.gens_msm` on the fabric's
device (:meth:`...parallel.fabric.MpcFabric.shared_gens_msm`), against the
generator tensors cached there from ``_DEVICE_MIN`` points on; the IPP
runs its round MSMs against the same tensors.  The commitments of
``batch_commit`` are two-point MSMs on the host.
"""

from __future__ import annotations

from ...generators import BulletproofGens, PedersenGens, device_gens
from ...ops import backend
from ...ops.curve import StarkPoint
from ...ops.field import Scalar, scalar_powers
from ...parallel.fabric import AuthenticatedScalarVector, MpcFabric
from ...transcript import HashChainTranscript, MpcTranscript
from ...utils.errors import InvalidGeneratorsLengthError, MissingAssignmentError, MultiproverError
from ..r1cs.linear_combination import (
    COMMITTED,
    MULT_LEFT,
    MULT_OUT,
    MULT_RIGHT,
    ONE,
    LinearCombination,
    Variable,
    _as_lc,
)
from .authenticated_poly import AuthenticatedPoly6, AuthenticatedVecPoly3
from .mpc_constraint_system import MpcRandomizableConstraintSystem, MpcRandomizedConstraintSystem
from .mpc_inner_product import SharedInnerProductProof
from .proof import PartiallySharedR1CSProof


class MpcProver(MpcRandomizableConstraintSystem):
    def __init__(self, fabric: MpcFabric, pc_gens: PedersenGens, transcript: HashChainTranscript):
        transcript.r1cs_domain_sep()
        self.fabric = fabric
        self.pc_gens = pc_gens
        self._transcript = MpcTranscript(transcript)
        self.constraints: list[LinearCombination] = []
        self.a_L: list[AuthenticatedScalarVector] = []
        self.a_R: list[AuthenticatedScalarVector] = []
        self.a_O: list[AuthenticatedScalarVector] = []
        self.v: list[AuthenticatedScalarVector] = []
        self.v_blinding: list[AuthenticatedScalarVector] = []
        self.deferred_constraints = []
        self.pending_multiplier: int | None = None

    @classmethod
    def new_with_network(cls, network, beaver_source, pc_gens, transcript, *, device="cuda"):
        """A prover over a new fabric on ``network`` and ``beaver_source``,
        its MSMs and device shares on ``device``."""
        return cls(MpcFabric(network, beaver_source, device=device), pc_gens, transcript)

    # -- MpcConstraintSystem -----------------------------------------------------

    def party_id(self) -> int:
        return self.fabric.party_id

    def transcript(self) -> MpcTranscript:
        return self._transcript

    def num_constraints(self) -> int:
        return len(self.constraints)

    def num_multipliers(self) -> int:
        return len(self.a_O)

    def _push(self, l_val, r_val, o_val):
        i = len(self.a_L)
        self.a_L.append(l_val)
        self.a_R.append(r_val)
        self.a_O.append(o_val)
        return Variable.multiplier_left(i), Variable.multiplier_right(i), Variable.multiplier_output(i)

    def multiply(self, left, right):
        """One Beaver multiplication per gate."""
        left, right = _as_lc(left), _as_lc(right)
        l_val, r_val = self.eval(left), self.eval(right)
        l_var, r_var, o_var = self._push(l_val, r_val, self.fabric.beaver_mul(l_val, r_val))
        left, right = left.copy(), right.copy()
        left.add_term(l_var, Scalar(-1))
        right.add_term(r_var, Scalar(-1))
        self.constrain(left)
        self.constrain(right)
        return l_var, r_var, o_var

    def allocate(self, assignment: AuthenticatedScalarVector | None) -> Variable:
        if assignment is None:
            raise MissingAssignmentError("MPC prover requires a shared assignment")
        if self.pending_multiplier is None:
            zero = self.fabric.zeros_authenticated
            l_var, _, _ = self._push(assignment, zero(1), zero(1))
            self.pending_multiplier = l_var.index
            return l_var
        i = self.pending_multiplier
        self.pending_multiplier = None
        self.a_R[i] = assignment
        self.a_O[i] = self.fabric.beaver_mul(self.a_L[i], assignment)
        return Variable.multiplier_right(i)

    def allocate_multiplier(self, input_assignments):
        if input_assignments is None:
            raise MissingAssignmentError("MPC prover requires shared assignments")
        l_val, r_val = input_assignments
        return self._push(l_val, r_val, self.fabric.beaver_mul(l_val, r_val))

    def constrain(self, lc) -> None:
        self.constraints.append(_as_lc(lc))

    def eval(self, lc) -> AuthenticatedScalarVector:
        """A linear combination as a shared scalar."""
        acc = self.fabric.zeros_authenticated(1)
        const = Scalar(0)
        for var, coeff in _as_lc(lc).terms.items():
            if var.kind == MULT_LEFT:
                acc = acc + self.a_L[var.index].mul_public(coeff)
            elif var.kind == MULT_RIGHT:
                acc = acc + self.a_R[var.index].mul_public(coeff)
            elif var.kind == MULT_OUT:
                acc = acc + self.a_O[var.index].mul_public(coeff)
            elif var.kind == COMMITTED:
                acc = acc + self.v[var.index].mul_public(coeff)
            elif var.kind == ONE:
                const += coeff
        if not const.is_zero():
            acc = acc.add_public([const])
        return acc

    def specify_randomized_constraints(self, callback) -> None:
        self.deferred_constraints.append(callback)

    def constraints_satisfied(self) -> bool:
        """Open and check every constraint (a debug helper: it reveals the
        evaluations)."""
        evals = AuthenticatedScalarVector.concat([self.eval(c) for c in self.constraints])
        return all(v.is_zero() for v in evals.open())

    # -- commitments -----------------------------------------------------------------

    def batch_commit(self, owning_party: int, values, blindings, count: int | None = None):
        """Share and Pedersen-commit values owned by one party.  The owner
        passes lists of Scalars, the other party ``None`` and the expected
        ``count``.  Returns ``(commitments, variables)``."""
        if self.fabric.party_id == owning_party:
            k = len(values)
            shared = self.fabric.batch_share_scalars(list(values) + list(blindings), owning_party)
        else:
            if count is None:
                raise MultiproverError("non-owner must pass count")
            k = count
            shared = self.fabric.batch_share_scalars(None, owning_party, count=2 * k)
        return self._commit_shared_batch(shared[:k], shared[k:])

    def commit(self, owning_party: int, value, blinding):
        if self.fabric.party_id == owning_party:
            comms, variables = self.batch_commit(owning_party, [value], [blinding])
        else:
            comms, variables = self.batch_commit(owning_party, None, None, count=1)
        return comms[0], variables[0]

    def batch_commit_preshared(self, v_shares, b_shares):
        """Commit values the parties already hold as additive shares: plain
        per-party share lists (authenticated here) or authenticated vectors."""
        if not isinstance(v_shares, AuthenticatedScalarVector):
            v_shares = self.fabric.authenticate_preshared(list(v_shares))
        if not isinstance(b_shares, AuthenticatedScalarVector):
            b_shares = self.fabric.authenticate_preshared(list(b_shares))
        return self._commit_shared_batch(v_shares, b_shares)

    def commit_preshared(self, v_share: AuthenticatedScalarVector, b_share: AuthenticatedScalarVector):
        comms, variables = self._commit_shared_batch(v_share, b_share)
        return comms[0], variables[0]

    def _commit_shared_batch(self, v_shares, b_shares):
        bases = [self.pc_gens.B, self.pc_gens.B_blinding]
        pts = [self.fabric.shared_msm(AuthenticatedScalarVector.concat([v_shares[i], b_shares[i]]), bases)
               for i in range(len(v_shares))]
        commitments = self.fabric.open_authenticated_points(pts)
        variables = []
        for i, V in enumerate(commitments):
            variables.append(Variable.committed(len(self.v)))
            self.v.append(v_shares[i])
            self.v_blinding.append(b_shares[i])
            self._transcript.append_point(b"V", V)
        return commitments, variables

    # -- proving ---------------------------------------------------------------------

    def _flattened_constraints(self, z: Scalar):
        """The constraint rows folded by powers of z (public weights)."""
        n = len(self.a_L)
        wL = [Scalar(0)] * n
        wR = [Scalar(0)] * n
        wO = [Scalar(0)] * n
        wV = [Scalar(0)] * len(self.v)
        exp_z = z
        for lc in self.constraints:
            for var, coeff in lc.terms.items():
                if var.kind == MULT_LEFT:
                    wL[var.index] += exp_z * coeff
                elif var.kind == MULT_RIGHT:
                    wR[var.index] += exp_z * coeff
                elif var.kind == MULT_OUT:
                    wO[var.index] += exp_z * coeff
                elif var.kind == COMMITTED:
                    wV[var.index] -= exp_z * coeff
            exp_z = exp_z * z
        return wL, wR, wO, wV

    def _create_randomized_constraints(self):
        self.pending_multiplier = None
        if not self.deferred_constraints:
            self._transcript.r1cs_1phase_domain_sep()
            return
        self._transcript.r1cs_2phase_domain_sep()
        callbacks, self.deferred_constraints = self.deferred_constraints, []
        wrapped = RandomizingMpcProver(self)
        for cb in callbacks:
            cb(wrapped)

    def prove(self, bp_gens: BulletproofGens) -> PartiallySharedR1CSProof:
        """The collaborative proof; open it with ``.open()``."""
        fabric = self.fabric
        t = self._transcript
        t.append_u64(b"m", len(self.v))

        n1 = len(self.a_L)
        if bp_gens.gens_capacity < n1:
            raise InvalidGeneratorsLengthError()

        blinders = fabric.random_shared_scalars_authenticated(3 + 2 * n1)
        i_blinding1, o_blinding1, s_blinding1 = blinders[0], blinders[1], blinders[2]
        s_L1 = blinders[3 : 3 + n1]
        s_R1 = blinders[3 + n1 :]

        B_b = self.pc_gens.B_blinding
        cat = AuthenticatedScalarVector.concat
        msm = fabric.shared_gens_msm
        a_L1 = cat(self.a_L) if self.a_L else fabric.zeros_authenticated(0)
        a_R1 = cat(self.a_R) if self.a_R else fabric.zeros_authenticated(0)
        a_O1 = cat(self.a_O) if self.a_O else fabric.zeros_authenticated(0)
        A_I1, A_O1, S1 = fabric.open_authenticated_points([
            msm(cat([i_blinding1, a_L1, a_R1]), bp_gens, [B_b], n1),
            msm(cat([o_blinding1, a_O1]), bp_gens, [B_b], n1, with_h=False),
            msm(cat([s_blinding1, s_L1, s_R1]), bp_gens, [B_b], n1),
        ])
        t.append_point(b"A_I1", A_I1)
        t.append_point(b"A_O1", A_O1)
        t.append_point(b"S1", S1)

        self._create_randomized_constraints()

        n = len(self.a_L)
        n2 = n - n1
        padded_n = 1 if n == 0 else 1 << (n - 1).bit_length()
        pad = padded_n - n
        if bp_gens.gens_capacity < padded_n:
            raise InvalidGeneratorsLengthError()

        if n2 > 0:
            blinders2 = fabric.random_shared_scalars_authenticated(3 + 2 * n2)
            i_blinding2, o_blinding2, s_blinding2 = blinders2[0], blinders2[1], blinders2[2]
            s_L2 = blinders2[3 : 3 + n2]
            s_R2 = blinders2[3 + n2 :]
            A_I2, A_O2, S2 = fabric.open_authenticated_points([
                msm(cat([i_blinding2, cat(self.a_L[n1:]), cat(self.a_R[n1:])]), bp_gens, [B_b], n, lo=n1),
                msm(cat([o_blinding2, cat(self.a_O[n1:])]), bp_gens, [B_b], n, lo=n1, with_h=False),
                msm(cat([s_blinding2, s_L2, s_R2]), bp_gens, [B_b], n, lo=n1),
            ])
        else:
            i_blinding2 = o_blinding2 = s_blinding2 = fabric.zeros_authenticated(1)
            s_L2 = s_R2 = fabric.zeros_authenticated(0)
            A_I2 = A_O2 = S2 = StarkPoint.identity()

        t.append_point(b"A_I2", A_I2)
        t.append_point(b"A_O2", A_O2)
        t.append_point(b"S2", S2)

        y = t.challenge_scalar(b"y")
        z = t.challenge_scalar(b"z")

        wL, wR, wO, wV = self._flattened_constraints(z)

        exp_y_inv = scalar_powers(y.inverse(), padded_n)
        y_pows = scalar_powers(y, padded_n)

        a_L = a_L1 if n1 == n else cat(self.a_L)
        a_R = a_R1 if n1 == n else cat(self.a_R)
        a_O = a_O1 if n1 == n else cat(self.a_O)
        sL = cat([s_L1, s_L2]) if n2 else s_L1
        sR = cat([s_R1, s_R2]) if n2 else s_R1

        # l(x) and r(x) over shares: linear, so local
        zeros = fabric.zeros_authenticated(n)
        l1 = a_L.add_public([exp_y_inv[i] * wR[i] for i in range(n)])
        r0 = zeros.add_public([wO[i] - y_pows[i] for i in range(n)])
        r1 = a_R.mul_public(y_pows[:n]).add_public(wL[:n])
        r3 = sR.mul_public(y_pows[:n])
        l_poly = AuthenticatedVecPoly3(zeros, l1, a_O, sL)
        r_poly = AuthenticatedVecPoly3(r0, r1, zeros, r3)

        t_poly = AuthenticatedVecPoly3.special_inner_product(l_poly, r_poly)

        t_blinders = fabric.random_shared_scalars_authenticated(5)
        bases = [self.pc_gens.B, self.pc_gens.B_blinding]
        T_1, T_3, T_4, T_5, T_6 = fabric.open_authenticated_points([
            fabric.shared_msm(cat([coeff, t_blinders[i]]), bases)
            for i, coeff in enumerate((t_poly.t1, t_poly.t3, t_poly.t4, t_poly.t5, t_poly.t6))
        ])
        t.append_point(b"T_1", T_1)
        t.append_point(b"T_3", T_3)
        t.append_point(b"T_4", T_4)
        t.append_point(b"T_5", T_5)
        t.append_point(b"T_6", T_6)

        u = t.challenge_scalar(b"u")
        x = t.challenge_scalar(b"x")

        # t_2_blinding = <wV, v_blinding> (wV public)
        t_2_blinding = fabric.zeros_authenticated(1)
        for c, vb in zip(wV, self.v_blinding):
            t_2_blinding = t_2_blinding + vb.mul_public(c)
        t_blinding_poly = AuthenticatedPoly6(t_blinders[0], t_2_blinding, t_blinders[1],
                                             t_blinders[2], t_blinders[3], t_blinders[4])

        t_x = t_poly.eval(x)
        t_x_blinding = t_blinding_poly.eval(x)
        l_vec = l_poly.eval(x)
        r_vec = r_poly.eval(x)
        if pad:
            l_vec = cat([l_vec, fabric.zeros_authenticated(pad)])
            r_vec = cat([r_vec, fabric.zeros_authenticated(pad).add_public(
                [-y_pows[i] for i in range(n, padded_n)])])

        i_blinding = i_blinding1 + i_blinding2.mul_public(u)
        o_blinding = o_blinding1 + o_blinding2.mul_public(u)
        s_blinding = s_blinding1 + s_blinding2.mul_public(u)
        e_blinding = (i_blinding + (o_blinding + s_blinding.mul_public(x)).mul_public(x)).mul_public(x)

        t_x_o, t_x_blinding_o, e_blinding_o = fabric.open_authenticated_batch(
            cat([t_x, t_x_blinding, e_blinding]))
        t.append_scalar(b"t_x", t_x_o)
        t.append_scalar(b"t_x_blinding", t_x_blinding_o)
        t.append_scalar(b"e_blinding", e_blinding_o)

        w = t.challenge_scalar(b"w")
        Q = w * self.pc_gens.B

        G_factors = [Scalar(1)] * n1 + [u] * (n2 + pad)
        H_factors = [yi * uf for yi, uf in zip(exp_y_inv, G_factors)]
        if padded_n < backend._DEVICE_MIN:
            G, H = bp_gens.share(0).G(padded_n), bp_gens.share(0).H(padded_n)
        else:
            G, H = device_gens(bp_gens, padded_n, 1, fabric.device)
        ipp = SharedInnerProductProof.create(t, Q, G_factors, H_factors, G, H, l_vec, r_vec, fabric)

        return PartiallySharedR1CSProof(
            A_I1, A_O1, S1, A_I2, A_O2, S2, T_1, T_3, T_4, T_5, T_6,
            t_x_o, t_x_blinding_o, e_blinding_o, ipp,
        )


class RandomizingMpcProver(MpcRandomizedConstraintSystem):
    """The second-phase view of the collaborative prover."""

    def __init__(self, prover: MpcProver):
        self.prover = prover

    def transcript(self):
        return self.prover.transcript()

    def num_constraints(self):
        return self.prover.num_constraints()

    def num_multipliers(self):
        return self.prover.num_multipliers()

    def multiply(self, left, right):
        return self.prover.multiply(left, right)

    def allocate(self, assignment):
        return self.prover.allocate(assignment)

    def allocate_multiplier(self, input_assignments):
        return self.prover.allocate_multiplier(input_assignments)

    def constrain(self, lc):
        self.prover.constrain(lc)

    def eval(self, lc):
        return self.prover.eval(lc)

    def challenge_scalar(self, label: bytes) -> Scalar:
        return self.prover._transcript.challenge_scalar(label)
