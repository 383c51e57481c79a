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

Two more provers give the same proof and transcript, and no route of
:meth:`InnerProductProof.create` takes them (the JAX package reaches them
from its tests and benches): :func:`_create_device`, the coefficient
tracking with two single MSMs a round and the host transcript, and
:func:`_create_host_folding`, the classic prover that folds G and H every
round.

The verifier replays the transcript in one ``keccak_transcript`` launch
(:func:`..transcript.replay`) for the challenges, builds the scalar
vectors on the host and checks one MSM (:func:`..ops.backend.dispatch_msm`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import FIELD_BITS, R, SCALAR_BYTES, STARK_POINT_BYTES
from ..ops.backend import _DEVICE_MIN, dispatch_msm
from ..ops.curve import StarkPoint
from ..ops.field import Scalar, inner_product
from ..transcript import (HashChainTranscript, innerproduct_domain_steps, replay,
                          validated_point_message)
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
        ``device``; likewise ``a_vec``, ``b_vec``, ``G_factors`` and
        ``H_factors`` are host scalar lists or ``(NW, n)`` tensors of
        canonical scalars.  From :data:`_DEVICE_MIN` the rounds run on
        ``device`` (the card unless the caller asks for the CPU), below it
        on the host over host lists; a tensor below it raises rather than
        move back to the host.  A card asked for and missing raises."""
        dev = resolve_device(device)
        vecs = (G_vec, H_vec, a_vec, b_vec, G_factors, H_factors)
        n = _width(G_vec)
        if not all(_width(v) == n for v in vecs):
            raise ValueError("IPP input vectors must share one length")
        if n & (n - 1):
            raise ValueError("IPP length must be a power of two")
        on_host = n < _DEVICE_MIN
        if on_host and any(isinstance(v, torch.Tensor) for v in vecs):
            raise ValueError(f"IPP below width {_DEVICE_MIN} runs on the host: pass host point lists and scalar lists")
        transcript.innerproduct_domain_sep(n)
        if on_host:
            return _create_host(transcript, Q, G_factors, H_factors, list(G_vec), list(H_vec),
                                a_vec, b_vec, dev)
        return _create_device_fused(transcript, Q, G_factors, H_factors, G_vec, H_vec,
                                    a_vec, b_vec, dev)

    def transcript_steps(self, n: int) -> list:
        """The verifier's transcript steps for width ``n``: the domain
        separator, then each round's L, R and challenge u.  Raises
        :class:`VerificationError` for a size or length the proof cannot
        have, ``ProofError`` for an identity L or R."""
        lg_n = len(self.L_vec)
        if lg_n >= 32:
            raise VerificationError("proof too large")
        if n != (1 << lg_n):
            raise VerificationError("length mismatch with proof")
        steps = innerproduct_domain_steps(n)
        for L, R_pt in zip(self.L_vec, self.R_vec):
            steps += [(b"L", validated_point_message(L)), (b"R", validated_point_message(R_pt)), (b"u", None)]
        return steps

    def replay_challenges(self, n: int, transcript: HashChainTranscript, device=None):
        """Replay the transcript's absorbs; returns the round challenges
        ``u_j`` as ints in ``[0, r)``.  On ``device`` the replay is one
        :func:`..transcript.replay` launch; with None it runs on the host
        transcript (the R1CS verifier's route, whose transcript is host-side)."""
        steps = self.transcript_steps(n)
        if device is not None:
            return replay([transcript], [steps], device)[0]
        us = []
        for label, msg in steps:
            if msg is None:
                us.append(int(transcript.challenge_scalar(label)))
            else:
                transcript.append_message(label, msg)
        return us

    def verification_scalars(self, n: int, transcript: HashChainTranscript):
        """``(u_j^2, u_j^-2, s)`` for the parent protocol's single MSM, the
        challenges replayed on the host transcript: ``s_0 = prod_j
        u_j^-1``, ``s_i = s_(i - 2^k) u_(lg n - k)^2`` with ``k = floor(lg i)``."""
        challenges = self.replay_challenges(n, transcript)
        return tuple([Scalar(x) for x in v] for v in self.scalars_from_challenges(challenges))

    def scalars_from_challenges(self, challenges: list[int]):
        """:meth:`verification_scalars` from the round challenges, as Python
        ints in ``[0, r)``; ``s`` grows by doubling, entries ``2^k .. 2^(k+1)
        - 1`` the first ``2^k`` times ``u_(lg n - k)^2``."""
        challenges_inv = [int(x) for x in Scalar.batch_inverse([Scalar(u) for u in challenges])]
        lg_n = len(challenges)
        allinv = 1
        for ci in challenges_inv:
            allinv = allinv * ci % R
        u_sq = [u * u % R for u in challenges]
        u_inv_sq = [u * u % R for u in challenges_inv]
        s = [allinv]
        for k in range(lg_n):
            u = u_sq[(lg_n - 1) - k]
            s += [x * u % R for x in s]
        return u_sq, u_inv_sq, s

    def verify(self, n: int, transcript: HashChainTranscript, G_factors: list[Scalar],
               H_factors: list[Scalar], P: StarkPoint, Q: StarkPoint, G, H, *,
               device="cuda") -> None:
        """Check ``P = <a s G_factors, G> + <b s^-1 H_factors, H> + a b Q
        - sum_j (u_j^2 L_j + u_j^-2 R_j)`` by one MSM on ``device`` (the card
        unless the caller asks for the CPU).  ``G`` and ``H`` are host point
        lists or ``(3, NW, n)`` point tensors; with a tensor the MSM runs
        over the points concatenated on its device.  The transcript replay
        is one launch on ``device``; the scalars are computed on the host.
        Raises :class:`VerificationError`."""
        challenges = self.replay_challenges(n, transcript, resolve_device(device))
        u_sq, u_inv_sq, s = self.scalars_from_challenges(challenges)
        a, b = int(self.a), int(self.b)
        g_a_s = [a * s_i % R * int(g_i) % R for g_i, s_i in zip(G_factors, s)]
        h_b_s = [b * s_inv % R * int(h_i) % R for h_i, s_inv in zip(H_factors, reversed(s))]
        scalars = ([a * b % R] + g_a_s + h_b_s + [(R - u) % R for u in u_sq]
                   + [(R - u) % R for u in u_inv_sq])
        LR = self.L_vec + self.R_vec
        if any(isinstance(v, torch.Tensor) for v in (G, H)):
            dev = (G if isinstance(G, torch.Tensor) else H).device
            points = torch.cat([_device_points([Q], dev), _device_points(G, dev),
                                _device_points(H, dev), _device_points(LR, dev)], dim=-1)
        else:
            points = [Q] + list(G) + list(H) + LR
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


def _width(vec) -> int:
    """Length of a host list, or the last axis of a point or scalar tensor."""
    return vec.shape[-1] if isinstance(vec, torch.Tensor) else len(vec)


def _device_scalars(xs, device) -> torch.Tensor:
    from ..ops import curve_t

    if isinstance(xs, torch.Tensor):
        return xs.to(device)
    return torch.as_tensor(curve_t.scalars_from_host(xs), device=device)


def _device_points(pts, device) -> torch.Tensor:
    from ..ops import curve_t

    if isinstance(pts, torch.Tensor):
        return pts.to(device)
    return torch.as_tensor(curve_t.points_from_host(pts), device=device)


def _fr_mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x y mod r`` lane by lane on ``csrc/vec2.cu`` (its plain version on
    a CPU tensor); ``y`` may be one ``(NW, 1)`` column."""
    from ..ops import kernels
    from ..ops.limb import FR

    return kernels.vec_mul(x.contiguous(), y.contiguous(), FR)


def _fr_inner(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``<x, y> mod r`` of ``(NW, n)`` words as one ``(NW, 1)`` column: the
    lane products on the kernel, their sum in one reduction."""
    from ..ops import limb

    return limb.sum_mod(_fr_mul(x, y), limb.FR)[:, None]


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


def _create_host_folding(transcript, Q, G_factors, H_factors, G, H, a, b, *,
                         device="cuda") -> InnerProductProof:
    """The classic folding prover over host lists: each round L and R are
    MSMs over the live halves of the folded generators
    (:func:`dispatch_msm` on ``device``), then G and H fold per element by
    a two-point ``StarkPoint.msm``, the factors folded into the first
    round.  The same proof and transcript as :func:`_create_host`; the
    caller has opened the transcript's IPP domain."""
    n = len(G)
    L_vec: list[StarkPoint] = []
    R_vec: list[StarkPoint] = []
    msm = lambda s, p: dispatch_msm(s, p, device=device)
    first = True
    while n > 1:
        n //= 2
        a_L, a_R = a[:n], a[n:]
        b_L, b_R = b[:n], b[n:]
        G_L, G_R = G[:n], G[n:]
        H_L, H_R = H[:n], H[n:]
        c_L = inner_product(a_L, b_R)
        c_R = inner_product(a_R, b_L)
        if first:
            L = msm([x * g for x, g in zip(a_L, G_factors[n : 2 * n])]
                    + [x * h for x, h in zip(b_R, H_factors[:n])] + [c_L], G_R + H_L + [Q])
            R_pt = msm([x * g for x, g in zip(a_R, G_factors[:n])]
                       + [x * h for x, h in zip(b_L, H_factors[n : 2 * n])] + [c_R], G_L + H_R + [Q])
        else:
            L = msm(a_L + b_R + [c_L], G_R + H_L + [Q])
            R_pt = msm(a_R + b_L + [c_R], G_L + H_R + [Q])
        L_vec.append(L)
        R_vec.append(R_pt)
        transcript.append_point(b"L", L)
        transcript.append_point(b"R", R_pt)
        u = transcript.challenge_scalar(b"u")
        u_inv = u.inverse()
        a = [al * u + u_inv * ar for al, ar in zip(a_L, a_R)]
        b = [bl * u_inv + u * br for bl, br in zip(b_L, b_R)]
        if first:
            G = [StarkPoint.msm([u_inv * gl_f, u * gr_f], [G_L[i], G_R[i]])
                 for i, (gl_f, gr_f) in enumerate(zip(G_factors[:n], G_factors[n : 2 * n]))]
            H = [StarkPoint.msm([u * hl_f, u_inv * hr_f], [H_L[i], H_R[i]])
                 for i, (hl_f, hr_f) in enumerate(zip(H_factors[:n], H_factors[n : 2 * n]))]
            first = False
        else:
            G = [StarkPoint.msm([u_inv, u], [gl, gr]) for gl, gr in zip(G_L, G_R)]
            H = [StarkPoint.msm([u, u_inv], [hl, hr]) for hl, hr in zip(H_L, H_R)]
    return InnerProductProof(L_vec, R_vec, Scalar(a[0]), Scalar(b[0]))


def _create_device(transcript, Q, G_factors, H_factors, G, H, a, b, *,
                   device="cuda") -> InnerProductProof:
    """The coefficient-tracking prover (module docstring) with its vectors
    on ``device`` (the card unless the caller asks for the CPU).

    Each round L and R are two :func:`..ops.msm.msm_device` calls of ``n +
    1`` points over ``[G | H | Q]`` (:func:`_ipp_round_indices`); the
    coefficient updates (on ``csrc/vec2.cu``, :func:`_fr_mul`) and the
    witness folds (:func:`..ops.fold.fold_scalars`) stay on the device, and
    only L and R cross to the host transcript, where the challenge is
    inverted.  The inputs are host lists or tensors
    as for :meth:`InnerProductProof.create`; the caller has opened the
    transcript's IPP domain.  Gives :func:`_create_host`'s proof and
    transcript."""
    from ..ops import curve_t as ct
    from ..ops import fold, limb
    from ..ops import msm as msm_mod
    from ..ops.limb import words_to_ints

    dev = resolve_device(device)
    n = _width(G)
    a_d, b_d = _device_scalars(a, dev), _device_scalars(b, dev)
    wG, wH = _device_scalars(G_factors, dev), _device_scalars(H_factors, dev)
    pts = torch.cat([_device_points(G, dev), _device_points(H, dev), _device_points([Q], dev)], dim=-1)
    word = lambda v: torch.as_tensor(limb.ints_to_words([v]), device=dev)      # (NW, 1)
    lanes = torch.arange(n, device=dev)
    L_vec: list[StarkPoint] = []
    R_vec: list[StarkPoint] = []
    cur = n
    while cur > 1:
        half = cur // 2
        a_L, a_R = a_d[:, :half], a_d[:, half:]
        b_L, b_R = b_d[:, :half], b_d[:, half:]
        c_L, c_R = _fr_inner(a_L, b_R), _fr_inner(a_R, b_L)
        r = lanes % cur
        hi = r >= half                                   # the classes of the right half
        at_hi, at_lo = torch.where(hi, r - half, 0), torch.where(hi, 0, r)
        hi_r = hi[None]
        sL = _fr_mul(torch.where(hi_r, wG, wH), torch.where(hi_r, a_L[:, at_hi], b_R[:, at_lo]))
        sR = _fr_mul(torch.where(hi_r, wH, wG), torch.where(hi_r, b_L[:, at_hi], a_R[:, at_lo]))
        idxL, idxR = (torch.as_tensor(ix, device=dev) for ix in _ipp_round_indices(n, cur))
        L_d = msm_mod.msm_device(torch.cat([sL, c_L], dim=-1), pts[:, :, idxL])
        R_d = msm_mod.msm_device(torch.cat([sR, c_R], dim=-1), pts[:, :, idxR])
        L, R_pt = ct.points_to_host(torch.stack([L_d, R_d], dim=-1))
        L_vec.append(L)
        R_vec.append(R_pt)
        transcript.append_point(b"L", L)
        transcript.append_point(b"R", R_pt)
        u = transcript.challenge_scalar(b"u")
        u_d, u_inv_d = word(int(u)), word(int(u.inverse()))
        if half > 1:                                     # the coefficients die with the last round
            wG = _fr_mul(wG, torch.where(hi_r, u_d, u_inv_d))
            wH = _fr_mul(wH, torch.where(hi_r, u_inv_d, u_d))
        a_d = fold.fold_scalars(u_d, u_inv_d, a_L, a_R)
        b_d = fold.fold_scalars(u_inv_d, u_d, b_L, b_R)
        cur = half
    a_fin, b_fin = words_to_ints(torch.cat([a_d[:, :1], b_d[:, :1]], dim=-1))
    return InnerProductProof(L_vec, R_vec, Scalar(a_fin), Scalar(b_fin))


def _create_device_fused(transcript, Q, G_factors, H_factors, G, H, a, b, device) -> InnerProductProof:
    """Every round on ``device`` (:func:`fused_ipp_body`, general branch over
    ``[G | H | Q | identity]``); one copy back to the host at the end, and
    the host transcript takes the device's final state."""
    from ..ops import curve_t as ct
    from ..ops import packio
    from ..ops import transcript_t as tj
    from ..ops.limb import NW, words_to_ints

    n = _width(a)
    sc = lambda xs: _device_scalars(xs, device)
    table = torch.cat([_device_points(G, device), _device_points(H, device),
                       _device_points([Q], device), ct.identity((1,), device)], dim=-1).contiguous()
    state = torch.as_tensor(tj.state_words(transcript.state), device=device)
    out = packio.pack_device(list(fused_ipp_body(n, device)(
        state, sc(a), sc(b), sc(G_factors), sc(H_factors), {device: table})))
    rounds = (n - 1).bit_length()
    shapes = [(4,), (NW,), (NW,), (rounds, NW, 2), (rounds, NW, 2), (rounds, 2)]
    state_np, a_fin, b_fin, xs, ys, iids = packio.unpack_np(out.cpu().numpy(), shapes)
    transcript.state = tj.state_bytes(state_np)
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


# one fused round's transcript run: L and R (8 words each), then u
_ROUND_STEPS = ((b"L", 8), (b"R", 8), (b"u", None))


def fused_ipp_body(n: int, device, table_gens: bool = False, mesh=None):
    """The fused IPP prover of size ``n`` (a power of two, at least 2).

    Returns ``run(state, a, b, wG, wH, tables, q_scale=None) -> (state,
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
    lane axis (:func:`..ops.msm._msm_multi_table_impl`).  The scalar
    products and sums run on ``csrc/vec2.cu`` (:func:`_fr_mul`).

    ``tables`` is ``{device: table}``, a copy on each device of ``mesh``
    (:class:`..parallel.sharded.Mesh`, its lead ``device``; ``device``
    alone by default): each round's pair MSM runs per shard over its slice
    of the lanes (:func:`..parallel.sharded.sharded_table_msm`); the
    products, folds and transcript stay on the lead.  The JAX package runs
    only the range prover's ``table_gens`` branch over a mesh."""
    from ..ops import kernels
    from ..ops import msm as msm_mod
    from ..ops import transcript_t as tj
    from ..ops.limb import FR, NW
    from ..parallel import sharded

    if mesh is None:
        mesh = sharded.Mesh([device])
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

    def run(state, a_d, b_d, wG, wH, tables, q_scale=None):
        xs, ys, iids = [], [], []
        for cur, recL, recR in rounds:
            half = cur // 2
            live = (live_h < half)[None]
            a_L = torch.where(live, a_d[:, :nh], 0)
            b_L = torch.where(live, b_d[:, :nh], 0)
            # entries past cur are zero, so the slices carry zeros past half
            a_R = a_d[:, half : half + nh]
            b_R = b_d[:, half : half + nh]
            c_L, c_R = _fr_inner(a_L, b_R), _fr_inner(a_R, b_L)

            r = lanes % cur
            hi = r >= half
            cls = torch.where(hi, r - half, r)
            at_hi = torch.where(hi, cls, 0)
            at_lo = torch.where(hi, 0, cls)
            aL_of, bL_of = a_L[:, at_hi], b_L[:, at_hi]
            bR_of, aR_of = b_R[:, at_lo], a_R[:, at_lo]
            hi_r = hi[None]
            sL = _fr_mul(torch.where(hi_r, wG, wH), torch.where(hi_r, aL_of, bR_of))
            sR = _fr_mul(torch.where(hi_r, wH, wG), torch.where(hi_r, bL_of, aR_of))
            if table_gens:
                sL = msm_mod.split_scalars_device(torch.cat([sL, _fr_mul(c_L, q_scale)], -1))
                sR = msm_mod.split_scalars_device(torch.cat([sR, _fr_mul(c_R, q_scale)], -1))
            else:
                sL, sR = torch.cat([sL, c_L], dim=-1), torch.cat([sR, c_R], dim=-1)
            LR = sharded.sharded_table_msm([(sL, recL), (sR, recR)], tables, mesh, c, bits)

            x, y, iid = tj.lazy_points_to_affine(LR)
            state, u = tj.absorb_many(state, _ROUND_STEPS, tj.points_words(x, y, iid))
            u_inv = kernels.mod_pow_static(u.contiguous(), R - 2, FR)
            xs.append(x), ys.append(y), iids.append(iid)

            wG = _fr_mul(wG, torch.where(hi_r, u, u_inv))
            wH = _fr_mul(wH, torch.where(hi_r, u_inv, u))
            a_next = kernels.vec_add(_fr_mul(a_L, u), _fr_mul(a_R, u_inv), FR)
            b_next = kernels.vec_add(_fr_mul(b_L, u_inv), _fr_mul(b_R, u), FR)
            zpad = a_next.new_zeros((NW, n - nh))
            a_d = torch.cat([a_next, zpad], dim=-1)
            b_d = torch.cat([b_next, zpad], dim=-1)
        return state, a_d[:, 0], b_d[:, 0], torch.stack(xs), torch.stack(ys), torch.stack(iids)

    return run
