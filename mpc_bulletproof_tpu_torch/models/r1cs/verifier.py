"""R1CS verifier: rebuilds the constraint structure from the commitments
and checks the proof with one MSM.

The port's copy of the JAX package's verifier.  The scalars are derived on
the host (:meth:`Verifier._verification_terms`); the MSM runs over the
proof's and the base points and party 0's G and H
(:func:`...ops.backend.gens_msm`).  Its route is chosen by size before
anything moves: below ``_DEVICE_MIN`` points the host Pippenger over the
host generators, else one MSM on ``device`` with the generator tensor
cached there.
"""

from __future__ import annotations

from ...generators import BulletproofGens, PedersenGens
from ...ops import backend
from ...ops.curve import StarkPoint
from ...ops.field import Scalar
from ...transcript import HashChainTranscript
from ...utils.device import resolve_device
from ...utils.errors import InvalidGeneratorsLengthError, VerificationError
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


class Verifier(RandomizableConstraintSystem):
    """The verifying constraint system (reference verifier.rs:26-51).

    Stores only the constraint *structure* — no witness; ``eval`` returns 0
    (verifier.rs:168-174).
    """

    def __init__(self, pc_gens: PedersenGens, transcript: HashChainTranscript):
        transcript.r1cs_domain_sep()
        self.pc_gens = pc_gens
        self._transcript = transcript
        self.constraints: list[LinearCombination] = []
        self.num_vars = 0
        self.V: list[StarkPoint] = []
        self.deferred_constraints = []
        self.pending_multiplier: int | None = None

    # -- ConstraintSystem ---------------------------------------------------

    def transcript(self) -> HashChainTranscript:
        return self._transcript

    def num_constraints(self) -> int:
        return len(self.constraints)

    def num_multipliers(self) -> int:
        return self.num_vars

    def get_weights(self) -> CircuitWeights:
        return extract_circuit_weights(self.constraints)

    def multiply(self, left, right):
        from .linear_combination import _as_lc

        left = _as_lc(left).copy()
        right = _as_lc(right).copy()
        i = self.num_vars
        self.num_vars += 1
        l_var = Variable.multiplier_left(i)
        r_var = Variable.multiplier_right(i)
        o_var = Variable.multiplier_output(i)
        left.add_term(l_var, Scalar(-1))
        right.add_term(r_var, Scalar(-1))
        self.constrain(left)
        self.constrain(right)
        return l_var, r_var, o_var

    def allocate(self, assignment=None) -> Variable:
        if self.pending_multiplier is None:
            i = self.num_vars
            self.num_vars += 1
            self.pending_multiplier = i
            return Variable.multiplier_left(i)
        i = self.pending_multiplier
        self.pending_multiplier = None
        return Variable.multiplier_right(i)

    def allocate_multiplier(self, input_assignments=None):
        i = self.num_vars
        self.num_vars += 1
        return (
            Variable.multiplier_left(i),
            Variable.multiplier_right(i),
            Variable.multiplier_output(i),
        )

    def commit_public(self, value) -> Variable:
        """Verifier-side public input: commitment with blinding one
        (verifier.rs:152-159)."""
        value = value if isinstance(value, Scalar) else Scalar(value)
        V = self.pc_gens.commit(value, Scalar(1))
        return self.commit(V)

    def constrain(self, lc) -> None:
        from .linear_combination import _as_lc

        self.constraints.append(_as_lc(lc))

    def eval(self, lc) -> Scalar:
        return Scalar(0)

    def specify_randomized_constraints(self, callback) -> None:
        self.deferred_constraints.append(callback)

    # -- verifier-specific API ----------------------------------------------

    def commit(self, commitment: StarkPoint) -> Variable:
        i = len(self.V)
        self.V.append(commitment)
        self._transcript.append_point(b"V", commitment)
        return Variable.committed(i)

    def _flattened_constraints(self, z: Scalar):
        """As the prover's, plus the constant term wc (verifier.rs:323-362)."""
        n = self.num_vars
        m = len(self.V)
        wL = [Scalar(0)] * n
        wR = [Scalar(0)] * n
        wO = [Scalar(0)] * n
        wV = [Scalar(0)] * m
        wc = Scalar(0)
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
                elif var.kind == ONE:
                    wc -= exp_z * coeff
            exp_z = exp_z * z
        return wL, wR, wO, wV, wc

    def _create_randomized_constraints(self):
        self.pending_multiplier = None
        if not self.deferred_constraints:
            self._transcript.r1cs_1phase_domain_sep()
            return
        self._transcript.r1cs_2phase_domain_sep()
        callbacks, self.deferred_constraints = self.deferred_constraints, []
        wrapped = RandomizingVerifier(self)
        for cb in callbacks:
            cb(wrapped)

    def verify(self, proof: R1CSProof, bp_gens: BulletproofGens, *, device="cuda") -> None:
        """Single-MSM verification on ``device`` (the card unless the caller
        asks for the CPU).  Raises :class:`VerificationError` on failure."""
        dev = resolve_device(device)
        scalars, points, padded_n = self._verification_terms(proof, bp_gens)
        if not backend.gens_msm(bp_gens, scalars, points, padded_n, device=dev).is_identity():
            raise VerificationError("R1CS proof failed the mega-check")

    def _verification_terms(self, proof: R1CSProof, bp_gens: BulletproofGens):
        """Replay the transcript and derive the mega-check on the host.

        Returns ``(scalars, points, padded_n)``: the scalars (ints mod r) in
        the order ``points + G(padded_n) + H(padded_n)``, ``points`` being
        ``[A_I1, A_O1, S1, A_I2, A_O2, S2, V.., T_1, T_3..T_6, B, B~, L..,
        R..]``.  Runs the deferred gadget callbacks, so it is called once per
        verifier."""
        t = self._transcript
        t.append_u64(b"m", len(self.V))

        n1 = self.num_vars
        t.validate_and_append_point(b"A_I1", proof.A_I1)
        t.validate_and_append_point(b"A_O1", proof.A_O1)
        t.validate_and_append_point(b"S1", proof.S1)

        self._create_randomized_constraints()

        n = self.num_vars
        n2 = n - n1
        padded_n = 1 if n == 0 else 1 << (n - 1).bit_length()
        pad = padded_n - n
        if bp_gens.gens_capacity < padded_n:
            raise InvalidGeneratorsLengthError()

        # Identity allowed here (1-phase case) — plain append.
        t.append_point(b"A_I2", proof.A_I2)
        t.append_point(b"A_O2", proof.A_O2)
        t.append_point(b"S2", proof.S2)

        y = t.challenge_scalar(b"y")
        z = t.challenge_scalar(b"z")

        t.validate_and_append_point(b"T_1", proof.T_1)
        t.validate_and_append_point(b"T_3", proof.T_3)
        t.validate_and_append_point(b"T_4", proof.T_4)
        t.validate_and_append_point(b"T_5", proof.T_5)
        t.validate_and_append_point(b"T_6", proof.T_6)

        u = t.challenge_scalar(b"u")
        x = t.challenge_scalar(b"x")

        t.append_scalar(b"t_x", proof.t_x)
        t.append_scalar(b"t_x_blinding", proof.t_x_blinding)
        t.append_scalar(b"e_blinding", proof.e_blinding)

        w = t.challenge_scalar(b"w")

        wL_s, wR_s, wO_s, wV_s, wc_s = self._flattened_constraints(z)

        u_sq, u_inv_sq, s_sc = proof.ipp_proof.verification_scalars(padded_n, t)

        # Scalar bookkeeping on raw ints; the MSM backends take ints directly.
        MOD = Scalar.MODULUS
        wL = [int(v) for v in wL_s]
        wR = [int(v) for v in wR_s]
        wO = [int(v) for v in wO_s]
        wV = [int(v) for v in wV_s]
        wc = int(wc_s)
        s = [int(v) for v in s_sc]
        a = int(proof.ipp_proof.a)
        b = int(proof.ipp_proof.b)
        yv, zv, uv, xv, wv = int(y), int(z), int(u), int(x), int(w)
        t_x = int(proof.t_x)

        y_inv = pow(yv, -1, MOD)
        y_inv_vec = [1] * padded_n
        for i in range(1, padded_n):
            y_inv_vec[i] = y_inv_vec[i - 1] * y_inv % MOD

        yneg_wR = [wRi * yi % MOD for wRi, yi in zip(wR, y_inv_vec)] + [0] * pad
        delta = sum(p * q for p, q in zip(yneg_wR[:n], wL)) % MOD

        u_for_g = [1] * n1 + [uv] * (n2 + pad)

        g_scalars = [
            uf * (xv * ywr - a * s_i) % MOD
            for ywr, uf, s_i in zip(yneg_wR, u_for_g, s[:padded_n])
        ]
        wL_pad = wL + [0] * pad
        wO_pad = wO + [0] * pad
        s_rev = list(reversed(s))
        h_scalars = [
            uf * (yi * (xv * wli + woi - b * s_inv) - 1) % MOD
            for yi, uf, s_inv, wli, woi in zip(
                y_inv_vec, u_for_g, s_rev[:padded_n], wL_pad, wO_pad
            )
        ]

        r = int(t.challenge_scalar(b"r"))

        xx = xv * xv % MOD
        rxx = r * xx % MOD
        xxx = xv * xx % MOD

        T_scalars = [
            r * xv % MOD, rxx * xv % MOD, rxx * xx % MOD,
            rxx * xxx % MOD, rxx * xx % MOD * xx % MOD,
        ]
        T_points = [proof.T_1, proof.T_3, proof.T_4, proof.T_5, proof.T_6]

        scalars = (
            [xv, xx, xxx, uv * xv % MOD, uv * xx % MOD, uv * xxx % MOD]
            + [wVi * rxx % MOD for wVi in wV]
            + T_scalars
            + [(wv * (t_x - a * b) + r * (xx * (wc + delta) % MOD - t_x)) % MOD]
            + [(-int(proof.e_blinding) - r * int(proof.t_x_blinding)) % MOD]
            + g_scalars
            + h_scalars
            + [int(v) for v in u_sq]
            + [int(v) for v in u_inv_sq]
        )
        unique_points = (
            [proof.A_I1, proof.A_O1, proof.S1, proof.A_I2, proof.A_O2, proof.S2]
            + self.V
            + T_points
            + [self.pc_gens.B, self.pc_gens.B_blinding]
            + proof.ipp_proof.L_vec
            + proof.ipp_proof.R_vec
        )
        # per-proof points first, then the G | H slices
        tail = 2 * len(proof.ipp_proof.L_vec)
        n_uniq = len(unique_points)
        scalars = (scalars[: n_uniq - tail] + (scalars[-tail:] if tail else [])
                   + g_scalars + h_scalars)
        return scalars, unique_points, padded_n


class RandomizingVerifier(RandomizedConstraintSystem):
    """Second-phase verifier view (reference verifier.rs:55-57, :182-265)."""

    def __init__(self, verifier: Verifier):
        self.verifier = verifier

    def transcript(self):
        return self.verifier.transcript()

    def num_constraints(self):
        return self.verifier.num_constraints()

    def num_multipliers(self):
        return self.verifier.num_multipliers()

    def get_weights(self):
        return self.verifier.get_weights()

    def multiply(self, left, right):
        return self.verifier.multiply(left, right)

    def allocate(self, assignment=None):
        return self.verifier.allocate(assignment)

    def allocate_multiplier(self, input_assignments=None):
        return self.verifier.allocate_multiplier(input_assignments)

    def commit_public(self, value):
        return self.verifier.commit_public(value)

    def constrain(self, lc):
        self.verifier.constrain(lc)

    def eval(self, lc):
        return self.verifier.eval(lc)

    def challenge_scalar(self, label: bytes) -> Scalar:
        return self.verifier._transcript.challenge_scalar(label)
