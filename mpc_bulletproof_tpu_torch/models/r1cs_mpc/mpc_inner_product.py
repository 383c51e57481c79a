"""The inner-product argument over secret-shared witness vectors.

The plain IPP with ``a`` and ``b`` authenticated shares: each round's
cross inner products are one batched Beaver multiplication, L and R are
MSMs of shared scalars over the public generators, and L and R are opened
(MAC-checked) every round so both parties' transcripts stay equal.  The
final ``a`` and ``b`` stay shared until :meth:`SharedInnerProductProof.open`.

The generators are not folded.  As the port's single-prover IPP does
(:func:`..inner_product._create_host`), the prover keeps one public
coefficient per original generator (``G_factors``, ``H_factors`` times the
rounds' ``u`` and ``u^-1``), so each round's L and R are MSMs over the
original ``[G | H | Q]`` with scalars ``share x coefficient``.  The map is
linear, so the MAC row stays a MAC of the share row, and L and R are the
group elements that folding gives.  Each round has four MSMs, the share
and MAC rows of L and of R: over generator tensors on the device (from
:func:`...generators.device_gens`) one multi-MSM call of the four
(:func:`...ops.msm._msm_multi_table_impl`), over host point lists four
:func:`...ops.backend.dispatch_msm` calls (the host Pippenger below its
size limit).
"""

from __future__ import annotations

import torch

from ...constants import FIELD_BITS, R
from ...ops.curve import StarkPoint
from ...ops.field import Scalar
from ...parallel.fabric import AuthenticatedPoint, AuthenticatedScalarVector, MpcFabric
from ...transcript import MpcTranscript
from ...utils.errors import MultiproverError
from ..inner_product import InnerProductProof, _ipp_round_indices, _width


class SharedInnerProductProof:
    def __init__(self, L_vec, R_vec, a, b, fabric):
        self.L_vec: list[StarkPoint] = L_vec  # opened during the protocol
        self.R_vec: list[StarkPoint] = R_vec
        self.a: AuthenticatedScalarVector = a  # still shared (length 1)
        self.b: AuthenticatedScalarVector = b
        self.fabric = fabric

    @staticmethod
    def create(transcript: MpcTranscript, Q: StarkPoint, G_factors: list[Scalar],
               H_factors: list[Scalar], G, H, a: AuthenticatedScalarVector,
               b: AuthenticatedScalarVector, fabric: MpcFabric) -> "SharedInnerProductProof":
        """Prove ``P = <a, G_factors G> + <b, H_factors H> + <a, b> Q`` over
        shares.  ``G`` and ``H`` are host point lists, or ``(3, NW, n)``
        point tensors on the fabric's device."""
        n = _width(G)
        if not (_width(H) == len(a) == len(b) == len(G_factors) == len(H_factors) == n):
            raise MultiproverError("IPP input vectors must share one length")
        if n & (n - 1):
            raise MultiproverError("IPP length must be a power of two")
        transcript.innerproduct_domain_sep(n)

        msms = _round_msms(fabric, G, H, Q, n)
        wG = [int(x) for x in G_factors]
        wH = [int(x) for x in H_factors]
        L_vec: list[StarkPoint] = []
        R_vec: list[StarkPoint] = []
        cur = n
        while cur > 1:
            half = cur // 2
            a_L, a_R = a[:half], a[half:]
            b_L, b_R = b[:half], b[half:]
            prods = fabric.beaver_mul(AuthenticatedScalarVector.concat([a_L, a_R]),
                                      AuthenticatedScalarVector.concat([b_R, b_L]))
            c_L, c_R = prods[:half].sum(), prods[half:].sum()

            # rows: L's shares, L's MACs, R's shares, R's MACs over the
            # original generators (layout of _ipp_round_indices)
            rows = []
            for side in ("shares", "macs"):
                aL, aR = [int(v) for v in getattr(a_L, side)], [int(v) for v in getattr(a_R, side)]
                bL, bR = [int(v) for v in getattr(b_L, side)], [int(v) for v in getattr(b_R, side)]
                sL, sR = [0] * (n + 1), [0] * (n + 1)
                for i in range(n):
                    r = i % cur
                    if r >= half:
                        sL[i] = wG[i] * aL[r - half] % R
                        sR[i] = wH[i] * bL[r - half] % R
                    else:
                        sL[i] = wH[i] * bR[r] % R
                        sR[i] = wG[i] * aR[r] % R
                sL[n] = int(getattr(c_L, side)[0])
                sR[n] = int(getattr(c_R, side)[0])
                rows.append((sL, sR))
            L_s, L_m, R_s, R_m = msms(cur, rows[0][0], rows[1][0], rows[0][1], rows[1][1])
            L, R_pt = fabric.open_authenticated_points([AuthenticatedPoint(fabric, L_s, L_m),
                                                        AuthenticatedPoint(fabric, R_s, R_m)])
            L_vec.append(L)
            R_vec.append(R_pt)
            transcript.append_point(b"L", L)
            transcript.append_point(b"R", R_pt)

            u = transcript.challenge_scalar(b"u")
            u_inv = u.inverse()
            uv, uv_inv = int(u), int(u_inv)
            for i in range(n):
                lo = (i % cur) < half
                wG[i] = wG[i] * (uv_inv if lo else uv) % R
                wH[i] = wH[i] * (uv if lo else uv_inv) % R
            a = a_L.mul_public(u) + a_R.mul_public(u_inv)
            b = b_L.mul_public(u_inv) + b_R.mul_public(u)
            cur = half
        return SharedInnerProductProof(L_vec, R_vec, a, b, fabric)

    def open(self) -> InnerProductProof:
        """MAC-checked opening of the shared tail; raises
        :class:`~...utils.errors.AuthenticationError` if a party changed its
        share."""
        opened = self.fabric.open_authenticated_batch(AuthenticatedScalarVector.concat([self.a, self.b]))
        return InnerProductProof(self.L_vec, self.R_vec, opened[0], opened[1])


def _round_msms(fabric: MpcFabric, G, H, Q: StarkPoint, n: int):
    """``msms(cur, L shares, L MACs, R shares, R MACs)`` -> the four points
    of one round, each row of ``n + 1`` ints over the round's points
    (:func:`..inner_product._ipp_round_indices` of ``[G | H | Q]``)."""
    from ...ops import curve_t
    from ...ops import msm as msm_mod
    from ...ops.backend import dispatch_msm

    dev = fabric.device
    if isinstance(G, torch.Tensor) or isinstance(H, torch.Tensor):
        table = torch.cat([G.to(dev), H.to(dev), torch.as_tensor(curve_t.points_from_host([Q]), device=dev),
                           curve_t.identity((1,), dev)], dim=-1).contiguous()
        c = msm_mod.select_window(n + 1)

        def msms(cur, *rows):
            idxL, idxR = (torch.as_tensor(ix, device=dev) for ix in _ipp_round_indices(n, cur))
            parts = [(torch.as_tensor(curve_t.scalars_from_host(row), device=dev), rec)
                     for row, rec in zip(rows, (idxL, idxL, idxR, idxR))]
            return curve_t.points_to_host(msm_mod._msm_multi_table_impl(parts, table, c, FIELD_BITS))

        return msms

    all_pts = list(G) + list(H) + [Q]

    def msms(cur, *rows):
        idxL, idxR = _ipp_round_indices(n, cur)
        ptsL, ptsR = [all_pts[j] for j in idxL], [all_pts[j] for j in idxR]
        return [dispatch_msm(row, pts, device=dev) for row, pts in zip(rows, (ptsL, ptsL, ptsR, ptsR))]

    return msms
