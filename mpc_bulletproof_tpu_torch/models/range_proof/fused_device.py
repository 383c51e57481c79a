"""The aggregated range prover with the whole protocol on the card.

Value and bit commitments, both challenge rounds, the t-polynomial, the
proof shares and the complete inner-product argument run as one sequence
of tensor operations on ``device``, with the hash chain there too
(:mod:`...ops.transcript_t`); nothing comes back to the host until the
finished proof is copied out once.

Byte for byte the JAX package's proof, given the same blinding stream: the
transcript absorb order is the dealer's (V_0..V_{m-1}, A, S, y, z | T_1,
T_2, x | t_x, t_x_blinding, e_blinding, w, the IPP's domain | each IPP
round's L, R, u; one keccak launch a run), and the
aggregated values are the sums of the per-party shares, computed as global
vector operations on the concatenated vectors.  Over a device mesh
(``prove_multiple_device(..., mesh=...)``) the MSMs, the bit sum and the
inner products split over its shards and the proof is the same bytes.
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from ...constants import R
from ...generators import (BulletproofGens, PedersenGens, device_gens, device_point_table,
                           gens_cache_entry)
from ...ops.curve import StarkPoint
from ...ops.field import Scalar
from ...ops.keccak import pad_label
from ...transcript import HashChainTranscript
from ...utils.device import normalize_device, resolve_device
from ...utils.errors import MPCError
from ..inner_product import InnerProductProof, fused_ipp_body

def _device_split_table(bp_gens: BulletproofGens, pc_gens: PedersenGens, n: int, m: int, device):
    """Split table of ``[G(nm) | H(nm) | B]``: ``(3, NW, 4 (2nm + 1) + 1)``."""
    from ...ops import curve_t
    from ...ops import msm as msm_mod

    per = gens_cache_entry(bp_gens)
    key = ("split", n, m, id(pc_gens), normalize_device(device))
    if key not in per:
        G, H = device_gens(bp_gens, n, m, device)
        B = torch.as_tensor(curve_t.points_from_host([pc_gens.B]), device=device)
        per[key] = msm_mod.build_split_affine_table(torch.cat([G, H, B], dim=-1))
    return per[key]


def _device_pc(pc_gens: PedersenGens, device):
    """Fixed-base tables ``[B rows | B_blinding rows]``."""
    per = gens_cache_entry(pc_gens)
    key = ("pc", normalize_device(device))
    if key not in per:
        per[key] = torch.cat([device_point_table(pc_gens.B, device),
                              device_point_table(pc_gens.B_blinding, device)], dim=-1)
    return per[key]


def _program(n: int, m: int, mesh):
    """The prover body for bitsize ``n`` and ``m`` parties over ``mesh``
    (:class:`...parallel.sharded.Mesh`; one device unsharded).

    The bulk splits over the mesh's shards, as the JAX package's one SPMD
    program over a device mesh: the S MSM and every IPP round's pair MSM
    per shard against a copy of the split table on each shard's device
    (``split_table`` is ``{device: table}``), the A bit sum and the
    t-polynomial's and ``zgamma``'s inner products per shard, each followed
    by its collective on the lead.  ``fixed_commit``, the transcript and
    the elementwise work run once, on the lead."""
    from ...ops import curve_t as ct
    from ...ops import kernels, limb
    from ...ops import msm as msm_mod
    from ...ops import packio
    from ...ops import transcript_t as tj
    from ...ops.limb import FR, NW
    from ...parallel import sharded

    device = mesh.lead
    nm = n * m
    ipp_run = fused_ipp_body(nm, device, table_gens=True, mesh=mesh)
    rec_S = torch.as_tensor(
        msm_mod.split_record_indices(np.arange(2 * nm), 2 * nm + 1), device=device)
    exp2 = torch.as_tensor(np.concatenate([limb.ints_to_words([1 << i for i in range(n)])] * m,
                                          axis=-1), device=device)
    FB_STRIDE = msm_mod.FB_WINDOWS * msm_mod.FB_TABLE  # B_blinding rows offset
    mul = lambda a, b: limb.mod_mul(a, b, FR)
    add = lambda a, b: limb.mod_add(a, b, FR)
    sub = lambda a, b: limb.mod_sub(a, b, FR)
    inner = lambda a, b: sharded.sharded_inner_product(a, b, mesh)[:, None]

    def absorb_points(state, labels, pts, challenges=()):
        """Affine-convert a ``(3, NW, k)`` batch, absorb with per-point
        labels, then squeeze ``challenges``: one keccak launch.  Returns
        ``(state, u, (x, y, is_id))``."""
        x, y, iid = tj.lazy_points_to_affine(pts)
        steps = [(label, 8) for label in labels] + [(label, None) for label in challenges]
        state, u = tj.absorb_many(state, steps, tj.points_words(x, y, iid))
        return state, u, (x, y, iid)

    def run(state, bits, v, gamma, alpha_sum, rho_sum, sL, sR, t1b_sum, t2b_sum,
            G, H, fb_table, split_table):
        # ---- bit commitments --------------------------------------------
        # V_j = v_j B + gamma_j B~; the blind terms alpha B~ and rho B~ ride
        # the same batched fixed-base evaluation
        zeros = v.new_zeros((NW, 1))
        sc_l = torch.cat([v, alpha_sum, rho_sum], dim=-1)
        sc_r = torch.cat([gamma, zeros, zeros], dim=-1)
        off_l = torch.tensor([0] * m + [FB_STRIDE] * 2, device=device)
        off_r = torch.full((m + 2,), FB_STRIDE, device=device)
        scan1 = msm_mod.fixed_commit(fb_table, off_l, sc_l, off_r, sc_r)
        V_pts, A_blind, S_blind = scan1[..., :m], scan1[..., m : m + 1], scan1[..., m + 1 :]

        # A = <a_L, G> + <a_R, H> + alpha B~: set bits select G_i, clear bits
        # select -H_i (a_R = a_L - 1), no scalar products
        bits_b = bits != 0
        ident = ct.identity((nm,), device)
        selG = ct._point_select(bits_b, G, ident)
        selH = ct._point_select(bits_b, ident, ct._point_neg(H))
        A_sum = sharded.sharded_point_sum(torch.cat([selG, selH], dim=-1), mesh)[..., None]
        A_pt = kernels.point_add(A_sum, A_blind.contiguous())

        # S = <s_L, G> + <s_R, H> + rho B~ by 64-bit chunks on the split table
        s4_S = msm_mod.split_scalars_device(torch.cat([sL, sR], dim=-1))
        S_msm = sharded.sharded_table_msm([(s4_S, rec_S)], split_table, mesh, msm_mod.SPLIT_WINDOW)
        S_pt = kernels.point_add(S_msm, S_blind.contiguous())

        state, yz, (Vx, Vy, Vid) = absorb_points(state, [b"V"] * m + [b"A", b"S"],
                                                 torch.cat([V_pts, A_pt, S_pt], dim=-1), (b"y", b"z"))
        (Vx, ASx), (Vy, ASy), (Vid, ASid) = (t.split([m, 2], dim=-1) for t in (Vx, Vy, Vid))
        y_ch, z_ch = yz[:, :1], yz[:, 1:]

        # ---- l/r polynomial coefficients over the nm lanes ---------------
        y_pows = limb.powers(y_ch[:, 0], nm, FR)
        z_pows_m = limb.powers(z_ch[:, 0], m, FR)
        zz = mul(z_ch, z_ch)
        zz_zj = mul(z_pows_m.repeat_interleave(n, dim=-1), zz)
        one = limb.from_const(1, (1,), device)
        bits_w = torch.cat([bits[None].long(), bits.new_zeros((NW - 1, nm)).long()])

        l0 = sub(bits_w, z_ch.expand(NW, nm))
        l1 = sL
        zm1b = add(sub(z_ch, one), bits_w)                 # a_R + z
        r0 = add(mul(y_pows, zm1b), mul(zz_zj, exp2))
        r1 = mul(y_pows, sR)

        # t-polynomial (aggregated over parties: global inner products)
        t0 = inner(l0, r0)
        t2 = inner(l1, r1)
        t1 = sub(sub(inner(add(l0, l1), add(r0, r1)), t0), t2)

        # T_1 = t1 B + t1b B~, T_2 likewise: one 2-lane table evaluation
        T_pts = msm_mod.fixed_commit(
            fb_table, torch.zeros(2, dtype=torch.int64, device=device), torch.cat([t1, t2], dim=-1),
            torch.full((2,), FB_STRIDE, device=device), torch.cat([t1b_sum, t2b_sum], dim=-1))
        state, x_ch, (Tx, Ty, Tid) = absorb_points(state, [b"T_1", b"T_2"], T_pts, (b"x",))

        # ---- proof shares (aggregated) -------------------------------------
        t_x = add(t0, mul(x_ch, add(t1, mul(x_ch, t2))))
        zgamma = inner(z_pows_m, gamma)
        t_x_blinding = add(mul(zz, zgamma), mul(x_ch, add(t1b_sum, mul(x_ch, t2b_sum))))
        e_blinding = add(alpha_sum, mul(x_ch, rho_sum))
        # the proof scalars, w and the IPP's domain separator: one run
        state, w_ch = tj.absorb_many(
            state, [(b"t_x", 4), (b"t_x_blinding", 4), (b"e_blinding", 4), (b"w", None),
                    (b"dom-sep", pad_label(b"ipp v1")), (b"n", nm.to_bytes(8, "little"))],
            tj.scalars_words(torch.cat([t_x, t_x_blinding, e_blinding], dim=-1)))
        # Q = w B never exists as a point: the IPP's Q term rides base B of
        # the split table with scalar c w

        # ---- the IPP over l(x), r(x) ---------------------------------------
        l_vec = add(l0, mul(x_ch, l1))
        r_vec = add(r0, mul(x_ch, r1))
        y_inv = kernels.mod_pow_static(y_ch.contiguous(), R - 2, FR)
        wH = limb.powers(y_inv[:, 0], nm, FR)
        wG = limb.from_const(1, (nm,), device)
        state, a_fin, b_fin, Lx, Ly, Lid = ipp_run(state, l_vec, r_vec, wG, wH, split_table, w_ch)

        return packio.pack_device([
            state, Vx, Vy, Vid, ASx, ASy, ASid, Tx, Ty, Tid,
            t_x, t_x_blinding, e_blinding, a_fin, b_fin, Lx, Ly, Lid,
        ])

    return run


def prove_multiple_device(
    bp_gens: BulletproofGens,
    pc_gens: PedersenGens,
    transcript: HashChainTranscript,
    values: list[int],
    blindings: list[Scalar],
    n: int,
    *,
    device="cuda",
    rng_bytes=None,
    mesh=None,
):
    """Aggregated proof that every value is in ``[0, 2^n)``, on ``device``.

    Same proof, commitments and final transcript state as the host
    party/dealer path.  ``rng_bytes(k)`` is the blinding stream; its draws
    come in the party order (per party: a, s, s_L, s_R; then per party
    t1, t2 blindings), so an injected stream reproduces the host's proof.
    ``mesh`` (:class:`...parallel.sharded.Mesh`) splits the prover's MSMs,
    point sum and inner products over its shards (:func:`_program`); the
    rest runs on its lead, which takes the place of ``device`` and must be
    of its type.  The proof is the same bytes.  Without one the prover runs
    on the mesh of ``device`` alone."""
    from ...ops import curve_t as ct
    from ...ops import packio
    from ...ops import transcript_t as tj
    from ...ops.limb import NW, words_to_ints
    from ...parallel.sharded import Mesh
    from .. import range_proof

    device = resolve_device(device)
    if mesh is None:
        mesh = Mesh([device])
    elif mesh.lead.type != device.type:
        raise ValueError(f"prove_multiple_device: mesh {mesh} is not on the device type {device.type}")
    device = mesh.lead
    if len(values) != len(blindings):
        raise MPCError("wrong number of blindings")
    m = len(values)
    nm = n * m
    if rng_bytes is None:
        # one bulk draw for the whole stream (48 bytes per scalar)
        buf = secrets.token_bytes(48 * (4 * m + 2 * nm))
        offset = [0]

        def rng_bytes(k: int) -> bytes:
            o = offset[0]
            offset[0] = o + k
            return buf[o : o + k]

    from .dealer import Dealer

    Dealer.new(bp_gens, pc_gens, transcript, n, m, device=device)
    if nm < 2:
        raise MPCError("the fused prover needs n * m >= 2")
    if any(not 0 <= int(v) < (1 << n) for v in values):
        raise MPCError("value out of range for bitsize")

    rand = lambda: Scalar(int.from_bytes(rng_bytes(48), "big"))
    a_blind, s_blind, sL_all, sR_all = [], [], [], []
    for _ in range(m):
        a_blind.append(rand())
        s_blind.append(rand())
        sL_all.extend(rand() for _ in range(n))
        sR_all.extend(rand() for _ in range(n))
    t1b, t2b = [], []
    for _ in range(m):
        t1b.append(rand())
        t2b.append(rand())

    bits = np.array([(int(v) >> i) & 1 for v in values for i in range(n)], dtype=np.int64)
    G_dev, H_dev = device_gens(bp_gens, n, m, device)
    fb_table = _device_pc(pc_gens, device)
    split_table = {dev: _device_split_table(bp_gens, pc_gens, n, m, dev) for dev in mesh.devices}

    sc = lambda xs: torch.as_tensor(ct.scalars_from_host(xs), device=device)
    sum_s = lambda xs: Scalar(sum(int(x) for x in xs))
    state = torch.as_tensor(tj.state_words(transcript.state), device=device)
    out = _program(n, m, mesh)(
        state, torch.as_tensor(bits, device=device), sc([Scalar(int(v)) for v in values]),
        sc(blindings), sc([sum_s(a_blind)]), sc([sum_s(s_blind)]), sc(sL_all), sc(sR_all),
        sc([sum_s(t1b)]), sc([sum_s(t2b)]), G_dev, H_dev, fb_table, split_table,
    )

    rounds = (nm - 1).bit_length()
    shapes = [
        (4,),
        (NW, m), (NW, m), (m,),          # V
        (NW, 2), (NW, 2), (2,),          # A, S
        (NW, 2), (NW, 2), (2,),          # T_1, T_2
        (NW, 1), (NW, 1), (NW, 1),       # t_x, t_x_blinding, e_blinding
        (NW,), (NW,),                    # a, b
        (rounds, NW, 2), (rounds, NW, 2), (rounds, 2),  # L/R per round
    ]
    (state_np, Vx, Vy, Vid, ASx, ASy, ASid, Tx, Ty, Tid,
     t_x, t_xb, e_b, a_fin, b_fin, Lx, Ly, Lid) = packio.unpack_np(out.cpu().numpy(), shapes)
    transcript.state = tj.state_bytes(state_np)

    def pts_of(x, y, iid):
        xs, ys = words_to_ints(x), words_to_ints(y)
        return [StarkPoint.identity() if iid[k] else StarkPoint(xs[k], ys[k])
                for k in range(len(xs))]

    sc1 = lambda col: Scalar(words_to_ints(col)[0])
    V_list = pts_of(Vx, Vy, Vid)
    A_pt, S_pt = pts_of(ASx, ASy, ASid)
    T1_pt, T2_pt = pts_of(Tx, Ty, Tid)
    L_vec, R_vec = [], []
    for rnd in range(rounds):
        L_pt, R_pt = pts_of(Lx[rnd], Ly[rnd], Lid[rnd])
        L_vec.append(L_pt)
        R_vec.append(R_pt)
    ipp = InnerProductProof(L_vec, R_vec, sc1(a_fin[:, None]), sc1(b_fin[:, None]))
    proof = range_proof.RangeProof(
        A=A_pt, S=S_pt, T_1=T1_pt, T_2=T2_pt,
        t_x=sc1(t_x), t_x_blinding=sc1(t_xb), e_blinding=sc1(e_b), ipp_proof=ipp,
    )
    return proof, V_list
