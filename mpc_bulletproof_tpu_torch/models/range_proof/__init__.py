"""Aggregated 64-bit range proofs: the proof type, its codec, the prover
entry points, which run the whole protocol on the card
(:mod:`.fused_device`), the verifiers, and the party/dealer protocol
(:mod:`.party`, :mod:`.dealer`, :mod:`.messages`) for an aggregation whose
m values are held by m parties and assembled by a dealer.

Verification replays the whole transcript in one ``keccak_transcript``
launch (a batch's transcripts in one), derives the scalars on the host
(:meth:`RangeProof._verification_terms`), then checks one MSM over
``[A, S, T_1, T_2, V.., B, B~, L.., R..] + G + H`` on the card
(:func:`...ops.backend.gens_msm`), with G and H from the device
generator cache the prover fills.

Proof layout: ``{A, S, T_1, T_2, t(x), ~t(x), ~e}`` followed by the IPP,
``(9 + 2 log2(n m)) * 32`` bytes; the same bytes as the JAX package's
``RangeProof``.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from ...constants import SCALAR_BYTES, STARK_POINT_BYTES
from ...generators import BulletproofGens, PedersenGens
from ...ops import backend
from ...ops.curve import StarkPoint
from ...ops.field import Scalar, sum_of_powers
from ...ops.curve import stark_point_to_transcript_bytes
from ...transcript import (HashChainTranscript, rangeproof_domain_steps, replay, scalar_message,
                           validated_point_message)
from ...utils.device import resolve_device
from ...utils.errors import FormatError, VerificationError
from ..inner_product import InnerProductProof
from .dealer import Dealer  # noqa: F401
from .messages import (  # noqa: F401
    BitChallenge,
    BitCommitment,
    PolyChallenge,
    PolyCommitment,
    ProofShare,
)
from .party import Party  # noqa: F401


@dataclass
class RangeProof:
    A: StarkPoint
    S: StarkPoint
    T_1: StarkPoint
    T_2: StarkPoint
    t_x: Scalar
    t_x_blinding: Scalar
    e_blinding: Scalar
    ipp_proof: InnerProductProof

    @staticmethod
    def prove_multiple(
        bp_gens: BulletproofGens,
        pc_gens: PedersenGens,
        transcript: HashChainTranscript,
        values: list[int],
        blindings: list[Scalar],
        n: int,
        *,
        device="cuda",
        rng_bytes=None,
    ) -> tuple["RangeProof", list[StarkPoint]]:
        """Aggregated proof that every value is in ``[0, 2^n)``; returns the
        proof and the value commitments.  Runs on the card unless
        ``device="cpu"``; raises when asked for a card that is not there.
        ``rng_bytes(k)`` optionally supplies the blinding stream."""
        from .fused_device import prove_multiple_device

        return prove_multiple_device(bp_gens, pc_gens, transcript, values, blindings, n,
                                     device=device, rng_bytes=rng_bytes)

    @staticmethod
    def prove_single(
        bp_gens: BulletproofGens,
        pc_gens: PedersenGens,
        transcript: HashChainTranscript,
        v: int,
        v_blinding: Scalar,
        n: int,
        *,
        device="cuda",
        rng_bytes=None,
    ) -> tuple["RangeProof", StarkPoint]:
        """Proof that ``v`` is in ``[0, 2^n)``: :meth:`prove_multiple` with
        one party."""
        proof, comms = RangeProof.prove_multiple(bp_gens, pc_gens, transcript, [v], [v_blinding], n,
                                                 device=device, rng_bytes=rng_bytes)
        return proof, comms[0]

    # ------------------------------------------------------------------
    # verification
    # ------------------------------------------------------------------

    def verify_multiple(
        self,
        bp_gens: BulletproofGens,
        pc_gens: PedersenGens,
        transcript: HashChainTranscript,
        value_commitments: list[StarkPoint],
        n: int,
        *,
        device="cuda",
    ) -> None:
        """Aggregated verification by one MSM on ``device`` (the card unless
        the caller asks for the CPU).  Raises :class:`VerificationError`."""
        dev = resolve_device(device)
        (g_scalars, h_scalars), scalars, points = self._verification_terms(
            bp_gens, pc_gens, transcript, value_commitments, n, device=dev)
        mega = backend.gens_msm(bp_gens, scalars + g_scalars + h_scalars, points, n,
                                len(value_commitments), device=dev)
        if not mega.is_identity():
            raise VerificationError("range proof failed verification")

    def _verification_terms(
        self,
        bp_gens: BulletproofGens,
        pc_gens: PedersenGens,
        transcript: HashChainTranscript,
        value_commitments: list[StarkPoint],
        n: int,
        *,
        device,
    ):
        """The verification MSM's scalars: the transcript replayed in one
        launch on ``device`` (:func:`...transcript.replay`), the rest on the
        host.  The transcript ends where the host route would leave it.

        Returns ``((g_scalars, h_scalars), scalars, points)``: ints mod r,
        the g/h lists aligned with the aggregated generator vectors (so
        :meth:`verify_batch` can merge them across proofs), ``scalars`` and
        ``points`` in the order ``[A, S, T_1, T_2, V.., B, B~, L.., R..]``."""
        return RangeProof._replayed_terms([self], bp_gens, pc_gens, [transcript], [value_commitments], n,
                                          resolve_device(device))[0]

    @staticmethod
    def _replayed_terms(proofs, bp_gens, pc_gens, transcripts, commitment_lists, n: int, device) -> list:
        """:meth:`_verification_terms` of each proof, every transcript
        replayed in one launch."""
        m = len(commitment_lists[0])
        if n <= 0 or (n & (n - 1)) or bp_gens.gens_capacity < n:
            raise VerificationError("invalid bitsize")
        if m <= 0 or (m & (m - 1)) or bp_gens.party_capacity < m:
            raise VerificationError("invalid aggregation size")
        runs = [proof._transcript_steps(comms, n) for proof, comms in zip(proofs, commitment_lists)]
        return [proof._terms(challenges, pc_gens, comms, n)
                for proof, comms, challenges in zip(proofs, commitment_lists,
                                                    replay(transcripts, runs, device))]

    def _transcript_steps(self, value_commitments: list[StarkPoint], n: int) -> list:
        """The verifier's whole transcript as steps: the domain separator,
        V.., A, S, y, z, T_1, T_2, x, the three scalars, w, the IPP's, c."""
        m = len(value_commitments)
        point = validated_point_message
        return (rangeproof_domain_steps(n, m)
                + [(b"V", stark_point_to_transcript_bytes(V)) for V in value_commitments]
                + [(b"A", point(self.A)), (b"S", point(self.S)), (b"y", None), (b"z", None),
                   (b"T_1", point(self.T_1)), (b"T_2", point(self.T_2)), (b"x", None),
                   (b"t_x", scalar_message(self.t_x)), (b"t_x_blinding", scalar_message(self.t_x_blinding)),
                   (b"e_blinding", scalar_message(self.e_blinding)), (b"w", None)]
                + self.ipp_proof.transcript_steps(n * m) + [(b"c", None)])

    def _terms(self, challenges: list[int], pc_gens: PedersenGens, value_commitments: list[StarkPoint], n: int):
        """The MSM's terms from the replayed challenges ``y, z, x, w, u.., c``."""
        m = len(value_commitments)
        MOD = Scalar.MODULUS
        nm = n * m
        a, b = int(self.ipp_proof.a), int(self.ipp_proof.b)
        yv, zv, xv, wv = challenges[:4]
        c = challenges[-1]  # weight of the second equation
        t_x, t_x_blinding, e_blinding = int(self.t_x), int(self.t_x_blinding), int(self.e_blinding)
        zz = zv * zv % MOD

        u_sq, u_inv_sq, s = self.ipp_proof.scalars_from_challenges(challenges[4:-1])

        y_inv = pow(yv, -1, MOD)
        y_inv_pows = [1] * nm
        for i in range(1, nm):
            y_inv_pows[i] = y_inv_pows[i - 1] * y_inv % MOD
        z_and_2 = [0] * nm                # z^(2 + j) 2^i, party-major
        exp_z = zz
        for j in range(m):
            exp_2 = exp_z
            for i in range(n):
                z_and_2[j * n + i] = exp_2
                exp_2 = exp_2 * 2 % MOD
            exp_z = exp_z * zv % MOD
        g_scalars = [(-zv - a * s_i) % MOD for s_i in s]
        h_scalars = [(zv + y_inv_pows[i] * (z_and_2[i] - b * s[nm - 1 - i])) % MOD
                     for i in range(nm)]

        # delta(y, z) = (z - z^2) <1, y^nm> - sum_j z^(j + 3) <1, 2^n>
        sum_y = int(sum_of_powers(Scalar(yv), nm))
        sum_z = int(sum_of_powers(Scalar(zv), m))
        delta = ((zv - zz) * sum_y - zv * zz % MOD * sum_z % MOD * ((1 << n) - 1)) % MOD
        basepoint_scalar = (wv * (t_x - a * b) + c * (delta - t_x)) % MOD
        value_commitment_scalars = []
        exp_z = c * zz % MOD
        for _ in range(m):
            value_commitment_scalars.append(exp_z)
            exp_z = exp_z * zv % MOD

        scalars = ([1, xv, c * xv % MOD, c * xv % MOD * xv % MOD] + value_commitment_scalars
                   + [basepoint_scalar, (-e_blinding - c * t_x_blinding) % MOD] + u_sq + u_inv_sq)
        points = ([self.A, self.S, self.T_1, self.T_2] + list(value_commitments)
                  + [pc_gens.B, pc_gens.B_blinding] + self.ipp_proof.L_vec + self.ipp_proof.R_vec)
        return (g_scalars, h_scalars), scalars, points

    def verify_single(
        self,
        bp_gens: BulletproofGens,
        pc_gens: PedersenGens,
        transcript: HashChainTranscript,
        V: StarkPoint,
        n: int,
        *,
        device="cuda",
    ) -> None:
        self.verify_multiple(bp_gens, pc_gens, transcript, [V], n, device=device)

    @staticmethod
    def verify_batch(
        proofs: list["RangeProof"],
        bp_gens: BulletproofGens,
        pc_gens: PedersenGens,
        transcripts: list[HashChainTranscript],
        commitment_lists: list[list[StarkPoint]],
        n: int,
        *,
        device="cuda",
    ) -> None:
        """Verify many proofs of one aggregation size by ONE MSM: each
        proof's equation is weighted by an independent random scalar ρ
        (``secrets``) and the shared generators' coefficients collapse.
        Raises :class:`VerificationError` if the batch fails."""
        if not (len(proofs) == len(transcripts) == len(commitment_lists)):
            raise VerificationError("batch length mismatch")
        if not proofs:
            return
        dev = resolve_device(device)
        m = len(commitment_lists[0])
        if any(len(cl) != m for cl in commitment_lists):
            raise VerificationError("batch requires a uniform aggregation size")

        MOD = Scalar.MODULUS
        nm = n * m
        g_acc, h_acc = [0] * nm, [0] * nm
        b_acc = bb_acc = 0
        uniq_scalars: list[int] = []
        uniq_points: list[StarkPoint] = []
        b_idx = 4 + m                     # [A, S, T1, T2, V.., B, B~, L.., R..]
        terms = RangeProof._replayed_terms(proofs, bp_gens, pc_gens, transcripts, commitment_lists, n, dev)
        for (g_sc, h_sc), scalars, points in terms:
            rho = int.from_bytes(secrets.token_bytes(32), "big") % MOD
            for i in range(nm):
                g_acc[i] = (g_acc[i] + rho * g_sc[i]) % MOD
                h_acc[i] = (h_acc[i] + rho * h_sc[i]) % MOD
            for idx, (sc, pt) in enumerate(zip(scalars, points)):
                if idx == b_idx:
                    b_acc = (b_acc + rho * sc) % MOD
                elif idx == b_idx + 1:
                    bb_acc = (bb_acc + rho * sc) % MOD
                else:
                    uniq_scalars.append(rho * sc % MOD)
                    uniq_points.append(pt)
        mega = backend.gens_msm(bp_gens, uniq_scalars + [b_acc, bb_acc] + g_acc + h_acc,
                                uniq_points + [pc_gens.B, pc_gens.B_blinding], n, m, device=dev)
        if not mega.is_identity():
            raise VerificationError("batch verification failed")

    def serialized_size(self) -> int:
        return 4 * STARK_POINT_BYTES + 3 * SCALAR_BYTES + self.ipp_proof.serialized_size()

    def to_bytes(self) -> bytes:
        buf = bytearray()
        for p in (self.A, self.S, self.T_1, self.T_2):
            buf += p.to_bytes()
        buf += self.t_x.to_bytes_be()
        buf += self.t_x_blinding.to_bytes_be()
        buf += self.e_blinding.to_bytes_be()
        buf += self.ipp_proof.to_bytes()
        return bytes(buf)

    @staticmethod
    def from_bytes(data: bytes) -> "RangeProof":
        if len(data) % 32 != 0 or len(data) < 7 * 32:
            raise FormatError("bad range proof length")
        try:
            A, S, T_1, T_2 = (StarkPoint.from_bytes(data[32 * i : 32 * i + 32]) for i in range(4))
        except ValueError as exc:
            raise FormatError(str(exc)) from exc
        t_x = Scalar.from_be_bytes_mod_order(data[128:160])
        t_x_blinding = Scalar.from_be_bytes_mod_order(data[160:192])
        e_blinding = Scalar.from_be_bytes_mod_order(data[192:224])
        ipp = InnerProductProof.from_bytes(data[224:])
        return RangeProof(A, S, T_1, T_2, t_x, t_x_blinding, e_blinding, ipp)

    def __eq__(self, other):
        return isinstance(other, RangeProof) and self.to_bytes() == other.to_bytes()
