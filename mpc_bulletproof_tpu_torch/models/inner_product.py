"""The Bulletproofs inner-product argument (IPP): proof type, codec, the
verifier, and the fused prover body that runs every round on the card.

Per round, the cross inner products ``c_L = <a_L, b_R>``, ``c_R = <a_R, b_L>``
and two (n+1)-term MSMs give L and R; the transcript absorbs them and
yields the challenge u; the witness folds in half (``a' = u a_L + u^-1 a_R``).
The prover tracks one coefficient per ORIGINAL generator instead of folding
the generators: after the rounds so far, folded generator k is
``sum_{i mod cur == k} w_i G_i``, so L and R are MSMs over the original
generators with coefficients ``w_i a_class(i)``, against the cached split
table.  The proof is ``(L_1..L_k, R_1..R_k, a, b)``.

The verifier replays the transcript on the host for the challenges, builds
the scalar vectors there and checks one MSM (:func:`..ops.backend.dispatch_msm`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import R, SCALAR_BYTES, STARK_POINT_BYTES
from ..ops.backend import dispatch_msm
from ..ops.curve import StarkPoint
from ..ops.field import Scalar
from ..transcript import HashChainTranscript
from ..utils.errors import FormatError, VerificationError


@dataclass
class InnerProductProof:
    L_vec: list[StarkPoint]
    R_vec: list[StarkPoint]
    a: Scalar
    b: Scalar

    def replay_challenges(self, n: int, transcript: HashChainTranscript):
        """Replay the transcript's absorbs; returns the round challenges
        ``u_j`` and their inverses."""
        lg_n = len(self.L_vec)
        if lg_n >= 32:
            raise VerificationError("proof too large")
        if n != (1 << lg_n):
            raise VerificationError("length mismatch with proof")
        transcript.innerproduct_domain_sep(n)
        challenges = []
        for L, R_pt in zip(self.L_vec, self.R_vec):
            transcript.validate_and_append_point(b"L", L)
            transcript.validate_and_append_point(b"R", R_pt)
            challenges.append(transcript.challenge_scalar(b"u"))
        return challenges, Scalar.batch_inverse(challenges)

    def verification_scalars(self, n: int, transcript: HashChainTranscript):
        """``(u_j^2, u_j^-2, s)`` for the parent protocol's single MSM:
        ``s_0 = prod_j u_j^-1``, ``s_i = s_(i - 2^k) u_(lg n - k)^2`` with
        ``k = floor(lg i)``."""
        challenges, challenges_inv = self.replay_challenges(n, transcript)
        lg_n = len(self.L_vec)
        allinv = Scalar(1)
        for ci in challenges_inv:
            allinv = allinv * ci
        u_sq = [u * u for u in challenges]
        u_inv_sq = [u * u for u in challenges_inv]
        s = [allinv]
        for i in range(1, n):
            lg_i = i.bit_length() - 1
            s.append(s[i - (1 << lg_i)] * u_sq[(lg_n - 1) - lg_i])
        return u_sq, u_inv_sq, s

    def verify(self, n: int, transcript: HashChainTranscript, G_factors: list[Scalar],
               H_factors: list[Scalar], P: StarkPoint, Q: StarkPoint, G: list[StarkPoint],
               H: list[StarkPoint], *, device="cuda") -> None:
        """Check ``P = <a s G_factors, G> + <b s^-1 H_factors, H> + a b Q
        - sum_j (u_j^2 L_j + u_j^-2 R_j)`` by one MSM on ``device`` (the card
        unless the caller asks for the CPU).  Raises :class:`VerificationError`."""
        u_sq, u_inv_sq, s = self.verification_scalars(n, transcript)
        g_a_s = [(self.a * s_i) * g_i for g_i, s_i in zip(G_factors, s)]
        h_b_s = [(self.b * s_inv) * h_i for h_i, s_inv in zip(H_factors, reversed(s))]
        scalars = ([self.a * self.b] + g_a_s + h_b_s + [-u for u in u_sq]
                   + [-u for u in u_inv_sq])
        points = [Q] + G + H + self.L_vec + self.R_vec
        if dispatch_msm(scalars, points, device=device) != P:
            raise VerificationError("inner product proof failed")

    def serialized_size(self) -> int:
        return len(self.L_vec) * 2 * STARK_POINT_BYTES + 2 * SCALAR_BYTES

    def to_bytes(self) -> bytes:
        buf = bytearray()
        for l_pt, r_pt in zip(self.L_vec, self.R_vec):
            buf += l_pt.to_bytes()
            buf += r_pt.to_bytes()
        buf += self.a.to_bytes_be()
        buf += self.b.to_bytes_be()
        return bytes(buf)

    @staticmethod
    def from_bytes(data: bytes) -> "InnerProductProof":
        b = len(data)
        if b < 2 * SCALAR_BYTES or b % 32 != 0:
            raise FormatError("bad IPP length")
        num_points = (b - 2 * SCALAR_BYTES) // STARK_POINT_BYTES
        if num_points % 2 != 0:
            raise FormatError("bad IPP point count")
        lg_n = num_points // 2
        if lg_n >= 32:
            raise FormatError("IPP too large")
        L_vec, R_vec = [], []
        for i in range(lg_n):
            pos = 2 * i * STARK_POINT_BYTES
            try:
                L_vec.append(StarkPoint.from_bytes(data[pos : pos + 32]))
                R_vec.append(StarkPoint.from_bytes(data[pos + 32 : pos + 64]))
            except ValueError as exc:
                raise FormatError(str(exc)) from exc
        pos = 2 * lg_n * STARK_POINT_BYTES
        a = Scalar.from_be_bytes_mod_order(data[pos : pos + SCALAR_BYTES])
        b_sc = Scalar.from_be_bytes_mod_order(data[pos + SCALAR_BYTES :])
        return InnerProductProof(L_vec, R_vec, a, b_sc)


def _ipp_round_indices(n: int, cur: int):
    """(idxL, idxR) point indices of one round over the layout
    ``[G_0..G_{n-1}, H_0..H_{n-1}, Q]``."""
    half = cur // 2
    i = np.arange(n)
    hi = (i % cur) >= half
    idxL = np.append(np.where(hi, i, n + i), 2 * n)
    idxR = np.append(np.where(hi, n + i, i), 2 * n)
    return idxL, idxR


def fused_ipp_body(n: int, device):
    """The fused IPP prover of size ``n`` (a power of two, at least 2) over
    the split table of ``[G(n) | H(n) | B]``.

    Returns ``run(state, a, b, wG, wH, table, q_scale) -> (state, a_final,
    b_final, xs, ys, iids)``: ``a``, ``b``, ``wG``, ``wH`` are ``(NW, n)``
    scalars, ``Q = q_scale B`` rides base B with scalar ``c q_scale``, and
    ``xs``, ``ys``, ``iids`` are the per-round affine L/R points
    ``(rounds, NW, 2)`` and identity flags ``(rounds, 2)``.  Every round keeps
    the full width ``n``, zero past the live length."""
    from ..ops import kernels, limb
    from ..ops import msm as msm_mod
    from ..ops import transcript_t as tj
    from ..ops.limb import FR, NW

    nh = n // 2
    records = lambda ix: torch.as_tensor(msm_mod.split_record_indices(ix, 2 * n + 1), device=device)
    rounds = []
    cur = n
    while cur > 1:
        iL, iR = _ipp_round_indices(n, cur)
        rounds.append((cur, records(iL), records(iR)))
        cur //= 2
    lanes = torch.arange(n, device=device)
    live_h = torch.arange(nh, device=device)

    def run(state, a_d, b_d, wG, wH, table, q_scale):
        xs, ys, iids = [], [], []
        for cur, recL, recR in rounds:
            half = cur // 2
            live = (live_h < half)[None]
            a_L = torch.where(live, a_d[:, :nh], 0)
            b_L = torch.where(live, b_d[:, :nh], 0)
            # entries past cur are zero, so the slices carry zeros past half
            a_R = a_d[:, half : half + nh]
            b_R = b_d[:, half : half + nh]
            c_L = limb.inner_product_mod(a_L, b_R, FR)[:, None]
            c_R = limb.inner_product_mod(a_R, b_L, FR)[:, None]

            r = lanes % cur
            hi = r >= half
            cls = torch.where(hi, r - half, r)
            at_hi = torch.where(hi, cls, 0)
            at_lo = torch.where(hi, 0, cls)
            aL_of, bL_of = a_L[:, at_hi], b_L[:, at_hi]
            bR_of, aR_of = b_R[:, at_lo], a_R[:, at_lo]
            hi_r = hi[None]
            sL = limb.mod_mul(torch.where(hi_r, wG, wH), torch.where(hi_r, aL_of, bR_of), FR)
            sR = limb.mod_mul(torch.where(hi_r, wH, wG), torch.where(hi_r, bL_of, aR_of), FR)
            cq_L = limb.mod_mul(c_L, q_scale, FR)
            cq_R = limb.mod_mul(c_R, q_scale, FR)
            s4L = msm_mod.split_scalars_device(torch.cat([sL, cq_L], dim=-1))
            s4R = msm_mod.split_scalars_device(torch.cat([sR, cq_R], dim=-1))
            LR = msm_mod._msm_multi_table_impl([(s4L, recL), (s4R, recR)], table,
                                               msm_mod.SPLIT_WINDOW)

            x, y, iid = tj.lazy_points_to_affine(LR)
            enc = tj.points_transcript_bytes(x, y, iid)       # (64, 2)
            state = tj.absorb(state, b"L", enc[:, 0])
            state = tj.absorb(state, b"R", enc[:, 1])
            state, u = tj.challenge_scalar(state, b"u")
            u_inv = kernels.mod_pow_static(u.contiguous(), R - 2, FR)
            xs.append(x), ys.append(y), iids.append(iid)

            wG = limb.mod_mul(wG, torch.where(hi_r, u, u_inv), FR)
            wH = limb.mod_mul(wH, torch.where(hi_r, u_inv, u), FR)
            a_next = limb.mod_add(limb.mod_mul(a_L, u, FR), limb.mod_mul(a_R, u_inv, FR), FR)
            b_next = limb.mod_add(limb.mod_mul(b_L, u_inv, FR), limb.mod_mul(b_R, u, FR), FR)
            zpad = a_next.new_zeros((NW, n - nh))
            a_d = torch.cat([a_next, zpad], dim=-1)
            b_d = torch.cat([b_next, zpad], dim=-1)
        return state, a_d[:, 0], b_d[:, 0], torch.stack(xs), torch.stack(ys), torch.stack(iids)

    return run
