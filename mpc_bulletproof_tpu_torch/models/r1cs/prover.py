"""Single-prover R1CS constraint-system prover.

The port's copy of the JAX package's prover: gadget code commits
high-level variables, allocates multipliers and constraints, then
:meth:`Prover.prove` runs the two-phase Bulletproofs constraint-system
protocol:

1. phase-1 commitments A_I1, A_O1, S1 over the first-phase witness;
2. deferred randomized constraints (callbacks may squeeze challenges);
3. phase-2 commitments (identity if no second-phase multipliers);
4. challenges y, z; constraints flattened by powers of z; blinded vector
   polynomials l(x), r(x) (degree 3) and t(x) = <l, r> (degree 6, t_0/t_2
   structural); T commitments, challenges u, x; evaluations + blindings;
5. the inner-product argument over (l(x), r(x)).

The phase MSMs run through :func:`...ops.backend.gens_msm`: from
``_DEVICE_MIN`` points on ``device`` against the generator tensor cached
there, below it on the host.  The IPP runs on ``device`` from width 32
(:meth:`..inner_product.InnerProductProof.create`).  Witness bookkeeping,
the keccak transcript, the t-polynomial and the Pedersen commitments stay
on the host, as in the JAX package.
"""

from __future__ import annotations

import secrets

from ... import generators
from ...generators import BulletproofGens, PedersenGens
from ...ops import backend
from ...ops.curve import StarkPoint
from ...ops.field import Scalar
from ...ops.poly import Poly6
from ...transcript import HashChainTranscript
from ...utils.device import resolve_device
from ...utils import profiling
from ...utils.errors import InvalidGeneratorsLengthError, MissingAssignmentError
from ..inner_product import InnerProductProof
from .constraint_system import (
    CircuitWeights,
    RandomizableConstraintSystem,
    RandomizedConstraintSystem,
    extract_circuit_weights,
)
from .linear_combination import (
    COMMITTED,
    MULT_LEFT,
    MULT_OUT,
    MULT_RIGHT,
    ONE,
    LinearCombination,
    Variable,
)
from .proof import R1CSProof


class Prover(RandomizableConstraintSystem):
    """The proving constraint system (reference prover.rs:27-50)."""

    def __init__(self, pc_gens: PedersenGens, transcript: HashChainTranscript):
        transcript.r1cs_domain_sep()
        self.pc_gens = pc_gens
        self._transcript = transcript
        self.constraints: list[LinearCombination] = []
        self.a_L: list[Scalar] = []
        self.a_R: list[Scalar] = []
        self.a_O: list[Scalar] = []
        self.v: list[Scalar] = []
        self.v_blinding: list[Scalar] = []
        self.deferred_constraints = []
        self.pending_multiplier: int | None = None

    # -- ConstraintSystem ---------------------------------------------------

    def transcript(self) -> HashChainTranscript:
        return self._transcript

    def num_constraints(self) -> int:
        return len(self.constraints)

    def num_multipliers(self) -> int:
        return len(self.a_O)

    def get_weights(self) -> CircuitWeights:
        return extract_circuit_weights(self.constraints)

    def multiply(self, left, right):
        left = _lc(left)
        right = _lc(right)
        l_val = self.eval(left)
        r_val = self.eval(right)
        o_val = l_val * r_val

        i = len(self.a_L)
        l_var = Variable.multiplier_left(i)
        r_var = Variable.multiplier_right(i)
        o_var = Variable.multiplier_output(i)
        self.a_L.append(l_val)
        self.a_R.append(r_val)
        self.a_O.append(o_val)

        left = left.copy()
        right = right.copy()
        left.add_term(l_var, Scalar(-1))
        right.add_term(r_var, Scalar(-1))
        self.constrain(left)
        self.constrain(right)
        return l_var, r_var, o_var

    def allocate(self, assignment: Scalar | None) -> Variable:
        if assignment is None:
            raise MissingAssignmentError("prover requires an assignment")
        if self.pending_multiplier is None:
            i = len(self.a_L)
            self.pending_multiplier = i
            self.a_L.append(assignment)
            self.a_R.append(Scalar(0))
            self.a_O.append(Scalar(0))
            return Variable.multiplier_left(i)
        i = self.pending_multiplier
        self.pending_multiplier = None
        self.a_R[i] = assignment
        self.a_O[i] = self.a_L[i] * self.a_R[i]
        return Variable.multiplier_right(i)

    def allocate_multiplier(self, input_assignments):
        if input_assignments is None:
            raise MissingAssignmentError("prover requires assignments")
        l_val, r_val = input_assignments
        o_val = l_val * r_val
        i = len(self.a_L)
        self.a_L.append(l_val)
        self.a_R.append(r_val)
        self.a_O.append(o_val)
        return (
            Variable.multiplier_left(i),
            Variable.multiplier_right(i),
            Variable.multiplier_output(i),
        )

    def commit_public(self, value) -> Variable:
        """Public statement variable: blinding fixed to one (prover.rs:167-173)."""
        _, var = self.commit(_scalar(value), Scalar(1))
        return var

    def constrain(self, lc: LinearCombination) -> None:
        self.constraints.append(_lc(lc))

    def eval(self, lc: LinearCombination) -> Scalar:
        acc = Scalar(0)
        for var, coeff in _lc(lc).terms.items():
            if var.kind == MULT_LEFT:
                acc += coeff * self.a_L[var.index]
            elif var.kind == MULT_RIGHT:
                acc += coeff * self.a_R[var.index]
            elif var.kind == MULT_OUT:
                acc += coeff * self.a_O[var.index]
            elif var.kind == COMMITTED:
                acc += coeff * self.v[var.index]
            elif var.kind == ONE:
                acc += coeff
            # ZERO contributes nothing
        return acc

    def specify_randomized_constraints(self, callback) -> None:
        self.deferred_constraints.append(callback)

    # -- prover-specific API -------------------------------------------------

    def commit(self, v: Scalar, v_blinding: Scalar):
        """Commit a high-level witness variable (prover.rs:319-329)."""
        i = len(self.v)
        self.v.append(_scalar(v))
        self.v_blinding.append(_scalar(v_blinding))
        V = self.pc_gens.commit(_scalar(v), _scalar(v_blinding))
        self._transcript.append_point(b"V", V)
        return V, Variable.committed(i)

    def constraints_satisfied(self) -> bool:
        return all(self.eval(c).is_zero() for c in self.constraints)

    def _flattened_constraints(self, z: Scalar):
        """Fold constraint rows by powers of z (prover.rs:342-379)."""
        n = len(self.a_L)
        m = len(self.v)
        wL = [Scalar(0)] * n
        wR = [Scalar(0)] * n
        wO = [Scalar(0)] * n
        wV = [Scalar(0)] * m
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
        """Run deferred gadget callbacks (prover.rs:383-402)."""
        self.pending_multiplier = None
        if not self.deferred_constraints:
            self._transcript.r1cs_1phase_domain_sep()
            return
        self._transcript.r1cs_2phase_domain_sep()
        callbacks, self.deferred_constraints = self.deferred_constraints, []
        wrapped = RandomizingProver(self)
        for cb in callbacks:
            cb(wrapped)

    def prove(self, bp_gens: BulletproofGens, *, device="cuda", rng_bytes=None) -> R1CSProof:
        """Produce an :class:`R1CSProof`.  The large MSMs and the IPP run on
        ``device`` (the card unless the caller asks for the CPU); a card
        asked for and missing raises.  The blinding RNG is keyed by the
        transcript, the witness and 32 bytes of entropy: ``rng_bytes(32)``
        when given, else ``secrets``.  The body runs inside the
        ``r1cs.prove`` span of :mod:`...utils.profiling`."""
        with profiling.span("r1cs.prove"):
            return self._prove_inner(bp_gens, device, rng_bytes)

    def _prove_inner(self, bp_gens: BulletproofGens, device, rng_bytes) -> R1CSProof:
        dev = resolve_device(device)
        t = self._transcript
        t.append_u64(b"m", len(self.v))

        # witness-rekeyed deterministic RNG for the blinding factors
        builder = t.build_rng()
        for v_b in self.v_blinding:
            builder = builder.rekey_with_witness_bytes(b"v_blinding", v_b.to_bytes_be())
        rng = builder.finalize(secrets.token_bytes(32) if rng_bytes is None else rng_bytes(32))

        n1 = len(self.a_L)
        if bp_gens.gens_capacity < n1:
            raise InvalidGeneratorsLengthError()

        i_blinding1 = rng.random_scalar()
        o_blinding1 = rng.random_scalar()
        s_blinding1 = rng.random_scalar()
        s_L1 = rng.random_scalars(n1)
        s_R1 = rng.random_scalars(n1)

        B_b = self.pc_gens.B_blinding
        A_I1 = backend.gens_msm(bp_gens, [i_blinding1] + self.a_L + self.a_R, [B_b], n1, device=dev)
        A_O1 = backend.gens_msm(bp_gens, [o_blinding1] + self.a_O, [B_b], n1, with_h=False,
                                device=dev)
        S1 = backend.gens_msm(bp_gens, [s_blinding1] + s_L1 + s_R1, [B_b], n1, device=dev)

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

        has_phase2 = n2 > 0
        if has_phase2:
            i_blinding2 = rng.random_scalar()
            o_blinding2 = rng.random_scalar()
            s_blinding2 = rng.random_scalar()
        else:
            i_blinding2 = o_blinding2 = s_blinding2 = Scalar(0)
        s_L2 = rng.random_scalars(n2)
        s_R2 = rng.random_scalars(n2)

        if has_phase2:
            A_I2 = backend.gens_msm(bp_gens, [i_blinding2] + self.a_L[n1:] + self.a_R[n1:], [B_b], n,
                                    lo=n1, device=dev)
            A_O2 = backend.gens_msm(bp_gens, [o_blinding2] + self.a_O[n1:], [B_b], n, lo=n1,
                                    with_h=False, device=dev)
            S2 = backend.gens_msm(bp_gens, [s_blinding2] + s_L2 + s_R2, [B_b], n, lo=n1,
                                 device=dev)
        else:
            A_I2 = A_O2 = S2 = StarkPoint.identity()

        t.append_point(b"A_I2", A_I2)
        t.append_point(b"A_O2", A_O2)
        t.append_point(b"S2", S2)

        y = t.challenge_scalar(b"y")
        z = t.challenge_scalar(b"z")

        wL, wR, wO, wV = self._flattened_constraints(z)

        # Numeric core on raw ints (profiling: Scalar-object overhead
        # dominates these O(n) loops otherwise).
        MOD = Scalar.MODULUS
        yv = int(y)
        y_inv = pow(yv, -1, MOD)
        exp_y_inv = [1] * padded_n
        for i in range(1, padded_n):
            exp_y_inv[i] = exp_y_inv[i - 1] * y_inv % MOD

        aL = [int(v) for v in self.a_L]
        aR = [int(v) for v in self.a_R]
        aO = [int(v) for v in self.a_O]
        wLi = [int(v) for v in wL]
        wRi = [int(v) for v in wR]
        wOi = [int(v) for v in wO]
        sL = [int(v) for v in s_L1] + [int(v) for v in s_L2]
        sR = [int(v) for v in s_R1] + [int(v) for v in s_R2]

        l1 = [0] * n
        l2 = aO
        l3 = sL
        r0 = [0] * n
        r1 = [0] * n
        r3 = [0] * n
        exp_y = 1
        for i in range(n):
            l1[i] = (aL[i] + exp_y_inv[i] * wRi[i]) % MOD
            r0[i] = (wOi[i] - exp_y) % MOD
            r1[i] = (exp_y * aR[i] + wLi[i]) % MOD
            r3[i] = exp_y * sR[i] % MOD
            exp_y = exp_y * yv % MOD

        def ip(u, v):
            return sum(p * q for p, q in zip(u, v)) % MOD

        # t(x) coefficients: special inner product with l0 = 0, r2 = 0.
        t_poly = Poly6(
            Scalar(ip(l1, r0)),
            Scalar((ip(l1, r1) + ip(l2, r0)) % MOD),
            Scalar((ip(l2, r1) + ip(l3, r0)) % MOD),
            Scalar((ip(l1, r3) + ip(l3, r1)) % MOD),
            Scalar(ip(l2, r3)),
            Scalar(ip(l3, r3)),
        )

        t_1_blinding = rng.random_scalar()
        t_3_blinding = rng.random_scalar()
        t_4_blinding = rng.random_scalar()
        t_5_blinding = rng.random_scalar()
        t_6_blinding = rng.random_scalar()

        T_1 = self.pc_gens.commit(t_poly.t1, t_1_blinding)
        T_3 = self.pc_gens.commit(t_poly.t3, t_3_blinding)
        T_4 = self.pc_gens.commit(t_poly.t4, t_4_blinding)
        T_5 = self.pc_gens.commit(t_poly.t5, t_5_blinding)
        T_6 = self.pc_gens.commit(t_poly.t6, t_6_blinding)

        t.append_point(b"T_1", T_1)
        t.append_point(b"T_3", T_3)
        t.append_point(b"T_4", T_4)
        t.append_point(b"T_5", T_5)
        t.append_point(b"T_6", T_6)

        u = t.challenge_scalar(b"u")
        x = t.challenge_scalar(b"x")

        # t_2_blinding = <z z^Q . W_V, v_blinding>
        t_2_blinding = Scalar(0)
        for c, vb in zip(wV, self.v_blinding):
            t_2_blinding += c * vb

        t_blinding_poly = Poly6(
            t_1_blinding, t_2_blinding, t_3_blinding,
            t_4_blinding, t_5_blinding, t_6_blinding,
        )

        xv = int(x)
        t_x = t_poly.eval(x)
        t_x_blinding = t_blinding_poly.eval(x)
        # l(x) = l1 x + l2 x^2 + l3 x^3;  r(x) = r0 + r1 x + r3 x^3
        xx = xv * xv % MOD
        xxx = xv * xx % MOD
        l_vec = [
            (l1[i] * xv + l2[i] * xx + l3[i] * xxx) % MOD for i in range(n)
        ] + [0] * pad
        r_vec = [
            (r0[i] + r1[i] * xv + r3[i] * xxx) % MOD for i in range(n)
        ] + [0] * pad
        # Pad r with -y^i so the IPP relation holds on the padded circuit.
        for i in range(n, padded_n):
            r_vec[i] = -exp_y % MOD
            exp_y = exp_y * yv % MOD

        i_blinding = i_blinding1 + u * i_blinding2
        o_blinding = o_blinding1 + u * o_blinding2
        s_blinding = s_blinding1 + u * s_blinding2
        e_blinding = x * (i_blinding + x * (o_blinding + x * s_blinding))

        t.append_scalar(b"t_x", t_x)
        t.append_scalar(b"t_x_blinding", t_x_blinding)
        t.append_scalar(b"e_blinding", e_blinding)

        w = t.challenge_scalar(b"w")
        Q = w * self.pc_gens.B

        uv = int(u)
        G_factors = [1] * n1 + [uv] * (n2 + pad)
        H_factors = [yi * uf % MOD for yi, uf in zip(exp_y_inv, G_factors)]

        if padded_n < backend._DEVICE_MIN:
            G, H = bp_gens.share(0).G(padded_n), bp_gens.share(0).H(padded_n)
        else:
            G, H = generators.device_gens(bp_gens, padded_n, 1, dev)
        ipp_proof = InnerProductProof.create(t, Q, G_factors, H_factors, G, H, l_vec, r_vec,
                                             device=dev)

        return R1CSProof(
            A_I1, A_O1, S1, A_I2, A_O2, S2,
            T_1, T_3, T_4, T_5, T_6,
            t_x, t_x_blinding, e_blinding, ipp_proof,
        )


class RandomizingProver(RandomizedConstraintSystem):
    """Second-phase prover view (reference prover.rs:59-61, :209-262)."""

    def __init__(self, prover: Prover):
        self.prover = prover

    def transcript(self):
        return self.prover.transcript()

    def num_constraints(self):
        return self.prover.num_constraints()

    def num_multipliers(self):
        return self.prover.num_multipliers()

    def get_weights(self):
        return self.prover.get_weights()

    def multiply(self, left, right):
        return self.prover.multiply(left, right)

    def allocate(self, assignment):
        return self.prover.allocate(assignment)

    def allocate_multiplier(self, input_assignments):
        return self.prover.allocate_multiplier(input_assignments)

    def commit_public(self, value):
        return self.prover.commit_public(value)

    def constrain(self, lc):
        self.prover.constrain(lc)

    def eval(self, lc):
        return self.prover.eval(lc)

    def challenge_scalar(self, label: bytes) -> Scalar:
        return self.prover._transcript.challenge_scalar(label)


def _scalar(v) -> Scalar:
    return v if isinstance(v, Scalar) else Scalar(v)


def _lc(v) -> LinearCombination:
    from .linear_combination import _as_lc

    return _as_lc(v)
