"""The Bulletproofs inner-product argument (IPP): proof type, codec, the
prover (:meth:`InnerProductProof.create`), the verifier, and the fused
prover body that runs every round on the card.

Per round, the cross inner products ``c_L = <a_L, b_R>``, ``c_R = <a_R, b_L>``
and two (n+1)-term MSMs give L and R; the transcript absorbs them and
yields the challenge u; the witness folds in half (``a' = u a_L + u^-1 a_R``).
The prover tracks one coefficient per ORIGINAL generator instead of folding
the generators: after the rounds so far, folded generator k is
``sum_{i mod cur == k} w_i G_i``, so L and R are MSMs over the original
generators with coefficients ``w_i a_class(i)``: against the cached split
table in the range prover, against ``[G | H | Q]`` otherwise.  Below a
width of :data:`_DEVICE_MIN` the prover runs on the host in Python
integers, as the JAX package's does.  The proof is ``(L_1..L_k, R_1..R_k,
a, b)``.

The verifier replays the transcript on the host for the challenges, builds
the scalar vectors there and checks one MSM (:func:`..ops.backend.dispatch_msm`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import FIELD_BITS, R, SCALAR_BYTES, STARK_POINT_BYTES
from ..ops.backend import _DEVICE_MIN, dispatch_msm
from ..ops.curve import StarkPoint
from ..ops.field import Scalar
from ..transcript import HashChainTranscript
from ..utils.device import resolve_device
from ..utils.errors import FormatError, VerificationError

@dataclass
class InnerProductProof:
    L_vec: list[StarkPoint]
    R_vec: list[StarkPoint]
    a: Scalar
    b: Scalar

    @staticmethod
    def create(transcript: HashChainTranscript, Q: StarkPoint, G_factors: list[Scalar],
               H_factors: list[Scalar], G_vec, H_vec, a_vec: list[Scalar], b_vec: list[Scalar],
               *, device="cuda") -> "InnerProductProof":
        """Prove ``P = <a, G_factors G> + <b, H_factors H> + <a, b> Q``.

        ``G_vec`` and ``H_vec`` are host point lists, or from
        :data:`_DEVICE_MIN` on also ``(3, NW, n)`` point tensors already on
        ``device``.  From :data:`_DEVICE_MIN` the rounds run on ``device``
        (the card unless the caller asks for the CPU), below it on the host
        over host lists; a point tensor below it raises rather than move
        back to the host.  A card asked for and missing raises."""
        dev = resolve_device(device)
        n = _width(G_vec)
        if not all(len(v) == n for v in (a_vec, b_vec, G_factors, H_factors)) or _width(H_vec) != n:
            raise ValueError("IPP input vectors must share one length")
        if n & (n - 1):
            raise ValueError("IPP length must be a power of two")
        on_host = n < _DEVICE_MIN
        if on_host and any(isinstance(v, torch.Tensor) for v in (G_vec, H_vec)):
            raise ValueError(f"IPP below width {_DEVICE_MIN} runs on the host: pass host point lists")
        transcript.innerproduct_domain_sep(n)
        if on_host:
            return _create_host(transcript, Q, G_factors, H_factors, list(G_vec), list(H_vec),
                                a_vec, b_vec, dev)
        return _create_device_fused(transcript, Q, G_factors, H_factors, G_vec, H_vec,
                                    a_vec, b_vec, dev)

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


def _width(pts) -> int:
    return pts.shape[-1] if isinstance(pts, torch.Tensor) else len(pts)


def _device_points(pts, device) -> torch.Tensor:
    from ..ops import curve_t

    if isinstance(pts, torch.Tensor):
        return pts.to(device)
    return torch.as_tensor(curve_t.points_from_host(pts), device=device)


def _create_host(transcript, Q, G_factors, H_factors, G, H, a, b, device) -> InnerProductProof:
    """The IPP rounds on the host, in Python integers with coefficient
    tracking (module docstring); L and R through :func:`dispatch_msm`."""
    n = len(G)
    if n == 1:
        return InnerProductProof([], [], Scalar(int(a[0])), Scalar(int(b[0])))
    wG = [int(x) for x in G_factors]
    wH = [int(x) for x in H_factors]
    av = [int(x) for x in a]
    bv = [int(x) for x in b]
    all_pts = list(G) + list(H) + [Q]
    L_vec: list[StarkPoint] = []
    R_vec: list[StarkPoint] = []
    cur = n
    while cur > 1:
        half = cur // 2
        a_L, a_R = av[:half], av[half:]
        b_L, b_R = bv[:half], bv[half:]
        sL = [0] * (n + 1)
        sR = [0] * (n + 1)
        for i in range(n):
            r = i % cur
            if r >= half:
                sL[i] = wG[i] * a_L[r - half] % R
                sR[i] = wH[i] * b_L[r - half] % R
            else:
                sL[i] = wH[i] * b_R[r] % R
                sR[i] = wG[i] * a_R[r] % R
        sL[n] = sum(x * y for x, y in zip(a_L, b_R)) % R
        sR[n] = sum(x * y for x, y in zip(a_R, b_L)) % R
        idxL, idxR = _ipp_round_indices(n, cur)
        L = dispatch_msm(sL, [all_pts[j] for j in idxL], device=device)
        R_pt = dispatch_msm(sR, [all_pts[j] for j in idxR], device=device)
        L_vec.append(L)
        R_vec.append(R_pt)
        transcript.append_point(b"L", L)
        transcript.append_point(b"R", R_pt)
        u = int(transcript.challenge_scalar(b"u"))
        u_inv = pow(u, -1, R)
        for i in range(n):
            lo = (i % cur) < half
            wG[i] = wG[i] * (u_inv if lo else u) % R
            wH[i] = wH[i] * (u if lo else u_inv) % R
        av = [(al * u + u_inv * ar) % R for al, ar in zip(a_L, a_R)]
        bv = [(bl * u_inv + u * br) % R for bl, br in zip(b_L, b_R)]
        cur = half
    return InnerProductProof(L_vec, R_vec, Scalar(av[0]), Scalar(bv[0]))


def _create_device_fused(transcript, Q, G_factors, H_factors, G, H, a, b, device) -> InnerProductProof:
    """Every round on ``device`` (:func:`fused_ipp_body`, general branch over
    ``[G | H | Q | identity]``); one copy back to the host at the end, and
    the host transcript takes the device's final state."""
    from ..ops import curve_t as ct
    from ..ops import packio
    from ..ops.limb import NW, words_to_ints

    n = len(a)
    sc = lambda xs: torch.as_tensor(ct.scalars_from_host(xs), device=device)
    table = torch.cat([_device_points(G, device), _device_points(H, device),
                       _device_points([Q], device), ct.identity((1,), device)], dim=-1).contiguous()
    state = torch.as_tensor(np.frombuffer(transcript.state, np.uint8).astype(np.int64), device=device)
    out = packio.pack_device(list(fused_ipp_body(n, device)(
        state, sc(a), sc(b), sc(G_factors), sc(H_factors), table)))
    rounds = (n - 1).bit_length()
    shapes = [(32,), (NW,), (NW,), (rounds, NW, 2), (rounds, NW, 2), (rounds, 2)]
    state_np, a_fin, b_fin, xs, ys, iids = packio.unpack_np(out.cpu().numpy(), shapes)
    transcript.state = bytes(int(v) for v in state_np)
    L_vec, R_vec = [], []
    for rnd in range(rounds):
        xv, yv = words_to_ints(xs[rnd]), words_to_ints(ys[rnd])
        for k, vec in ((0, L_vec), (1, R_vec)):
            vec.append(StarkPoint.identity() if iids[rnd, k] else StarkPoint(xv[k], yv[k]))
    return InnerProductProof(L_vec, R_vec, Scalar(words_to_ints(a_fin[:, None])[0]),
                             Scalar(words_to_ints(b_fin[:, None])[0]))


def _ipp_round_indices(n: int, cur: int):
    """(idxL, idxR) point indices of one round over the layout
    ``[G_0..G_{n-1}, H_0..H_{n-1}, Q]``."""
    half = cur // 2
    i = np.arange(n)
    hi = (i % cur) >= half
    idxL = np.append(np.where(hi, i, n + i), 2 * n)
    idxR = np.append(np.where(hi, n + i, i), 2 * n)
    return idxL, idxR


def fused_ipp_body(n: int, device, table_gens: bool = False):
    """The fused IPP prover of size ``n`` (a power of two, at least 2).

    Returns ``run(state, a, b, wG, wH, table, q_scale=None) -> (state,
    a_final, b_final, xs, ys, iids)``: ``a``, ``b``, ``wG``, ``wH`` are
    ``(NW, n)`` scalars, and ``xs``, ``ys``, ``iids`` are the per-round
    affine L/R points ``(rounds, NW, 2)`` and identity flags ``(rounds, 2)``.
    Every round keeps the full width ``n``, zero past the live length.

    ``table_gens=True`` (the range prover): ``table`` is the split table of
    ``[G(n) | H(n) | B]``, the round MSMs run on 64-bit chunks, and ``Q =
    q_scale B`` rides base B with scalar ``c q_scale``.  Otherwise ``table``
    is ``[G(n) | H(n) | Q | identity]`` and each round's L and R are one
    pair of 252-bit MSMs over its records (``c = select_window(n + 1)``):
    one sort, one bucket phase and one Horner chain with both outputs on the
    lane axis (:func:`..ops.msm._msm_multi_table_impl`)."""
    from ..ops import kernels, limb
    from ..ops import msm as msm_mod
    from ..ops import transcript_t as tj
    from ..ops.limb import FR, NW

    nh = n // 2
    if table_gens:
        records = lambda ix: torch.as_tensor(msm_mod.split_record_indices(ix, 2 * n + 1),
                                             device=device)
        c, bits = msm_mod.SPLIT_WINDOW, msm_mod.SPLIT_CHUNK_BITS
    else:
        records = lambda ix: torch.as_tensor(ix, device=device)
        c, bits = msm_mod.select_window(n + 1), FIELD_BITS
    rounds = []
    cur = n
    while cur > 1:
        iL, iR = _ipp_round_indices(n, cur)
        rounds.append((cur, records(iL), records(iR)))
        cur //= 2
    lanes = torch.arange(n, device=device)
    live_h = torch.arange(nh, device=device)

    def run(state, a_d, b_d, wG, wH, table, q_scale=None):
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
            if table_gens:
                sL = msm_mod.split_scalars_device(torch.cat([sL, limb.mod_mul(c_L, q_scale, FR)], -1))
                sR = msm_mod.split_scalars_device(torch.cat([sR, limb.mod_mul(c_R, q_scale, FR)], -1))
            else:
                sL, sR = torch.cat([sL, c_L], dim=-1), torch.cat([sR, c_R], dim=-1)
            LR = msm_mod._msm_multi_table_impl([(sL, recL), (sR, recR)], table, c, bits)

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
