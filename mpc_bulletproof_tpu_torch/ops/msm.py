"""Multi-scalar multiplications: variable-base, split-table and fixed-base.

* **Variable-base Pippenger** (:func:`msm_device`, :func:`msm_host_points`):
  the verifiers' MSMs over arbitrary points (the range-proof mega-check,
  the IPP check).  252-bit scalars in signed c-bit windows; the points are
  sorted by |digit| per window (``torch.sort(stable=True)``, the sign
  gathered beside), and the windows go through the bucket phase below in
  groups (:func:`_window_group`) that gather their records from ``[points
  | identity]`` straight into the scan layout (:func:`_msm_device_impl`).
  :func:`msm_device_pair` runs two same-width MSMs as one (one sort, one
  bucket phase, one Horner chain over ``[pA | pB | identity]``), and
  :func:`msm_device_split` one against a pre-shifted split table.

Every MSM of the fused range prover hits FIXED bases: the G/H generator
chains and the Pedersen bases.  So two precomputed tables serve them all.

* **Split table** (S commitment, each IPP round's L/R pair).  For every base
  ``P`` the table holds ``[P | 2^64 P | 2^128 P | 2^192 P]`` in affine form
  (``s P = sum_j chunk_j(s) 2^(64 j) P``), so a 252-bit MSM runs as one over
  64-bit chunks: 8 windows of c = 9 signed bits.  Pippenger per window: the
  points are sorted by digit (one stable sort), an unsegmented inclusive
  prefix scan runs over the sorted points (:func:`.kernels.point_scan_steps_inner`
  over contiguous chunks, chunk offsets by a log-depth lane scan), and the
  per-bucket running sums fall out as ``total - prefix[boundary]`` at the
  ``searchsorted`` bucket boundaries, because points have cheap inverses.
  The windows combine by Horner (:func:`.kernels.point_horner_multi`).
* **Fixed-base table** (V, T_1, T_2 and the blinding terms).  Rows
  ``d 2^(8 w) B`` for 32 windows of 8 bits: a commitment is 32 gathered
  points per base and one segmented sum (:func:`.kernels.point_reduce`).

Tables are ``(3, NW, N)`` point tensors whose points are affine or the
identity (``Z`` in ``{0, 1_M}``), gathered with ``index_select``.  Sorts
and searches are ``torch.sort(stable=True)`` and ``torch.searchsorted``.
Point additions go through the CUDA kernels (:mod:`.kernels`); everything
else is plain tensor code.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import FIELD_BITS
from ..utils.device import resolve_device
from . import curve_t, kernels
from .curve_t import _point_neg, _point_select, identity, to_affine_mont
from .limb import NW

SPLIT_CHUNK_BITS = 64
SPLIT_CHUNKS = 4
# Signed-digit window of the 64-bit chunks: 8 windows whose 1-bit top window
# stays in the signed bucket range (c = 8 would make it a full 8 bits and
# overflow the buckets).  The JAX package's value, kept so the shapes match.
SPLIT_WINDOW = 9
_SCAN_LANES = 16384  # lanes of one scan step: windows x chunks

FB_WINDOW_BITS = 8
FB_WINDOWS = 32  # 32 * 8 = 256 bits >= 252
FB_TABLE = 1 << FB_WINDOW_BITS


# ---------------------------------------------------------------------------
# digits
# ---------------------------------------------------------------------------

def _bits_at(words: torch.Tensor, lo: int, width: int) -> torch.Tensor:
    """Bits ``[lo, lo + width)`` of ``(NW, ...)`` words as int64 (width <= 32).
    Each word's part is masked, so a word read as negative is harmless."""
    out = None
    got = 0
    while got < width:
        k, off = divmod(lo + got, 64)
        if k >= words.shape[0]:
            break
        take = min(width - got, 64 - off)
        part = ((words[k] >> off) & ((1 << take) - 1)) << got
        out = part if out is None else out | part
        got += take
    return out if out is not None else torch.zeros_like(words[0])


def _digits(scalars: torch.Tensor, c: int, bits: int = FIELD_BITS) -> torch.Tensor:
    """``(NW, n)`` words -> ``(nw, n)`` unsigned c-bit digit rows."""
    nw = -(-bits // c)
    return torch.stack([_bits_at(scalars, c * i, c) for i in range(nw)])


def _signed_digits(scalars: torch.Tensor, c: int, bits: int = FIELD_BITS) -> torch.Tensor:
    """``(NW, n)`` words -> ``(nw, n)`` signed digits in ``[-2^(c-1), 2^(c-1)]``.

    A digit above ``2^(c-1)`` borrows ``2^c`` from the next window; the top
    window absorbs the last carry unsigned, so it must be at most ``c - 2``
    bits wide.  When c divides ``bits`` it is a full c bits and would
    overflow the buckets: such a c raises."""
    top_width = bits - (bits // c) * c if bits % c else c
    if top_width > c - 2:
        raise ValueError(f"window c={c}: top window would overflow signed buckets")
    raw = _digits(scalars, c, bits)
    half, full = 1 << (c - 1), 1 << c
    rows = []
    carry = torch.zeros_like(raw[0])
    for i in range(raw.shape[0]):
        d = raw[i] + carry
        if i == raw.shape[0] - 1:
            rows.append(d)
        else:
            carry = (d > half).long()
            rows.append(d - carry * full)
    return torch.stack(rows)


def _sort_digits(digits: torch.Tensor):
    """Stable sort of each window's ``|digit|``: ``(nw, n)`` signed digits ->
    ``(sorted |digit|, source order, sign in sorted order)``."""
    d_sorted, order = torch.sort(digits.abs(), dim=-1, stable=True)
    return d_sorted, order, torch.gather((digits < 0).long(), 1, order)


def _boundaries(d_sorted: torch.Tensor, c: int) -> torch.Tensor:
    """``(W, n)`` sorted ``|digit|`` -> ``(W, B - 1)`` sorted position of the
    last digit ``<= t`` for ``t = 0 .. B - 2`` (-1 when there is none)."""
    B = (1 << (c - 1)) + 1
    targets = torch.arange(0, B - 1, dtype=torch.int64, device=d_sorted.device)
    return torch.searchsorted(d_sorted.contiguous(), targets.expand(d_sorted.shape[0], -1).contiguous(),
                              right=True) - 1


# ---------------------------------------------------------------------------
# point helpers
# ---------------------------------------------------------------------------

def _fetch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather table records: ``idx`` of any shape -> ``(3, NW, *idx.shape)``."""
    flat = table.index_select(2, idx.reshape(-1))
    return flat.reshape(3, NW, *idx.shape)


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return kernels.point_add(a.contiguous(), b.contiguous())


def _reduce_sum(pts: torch.Tensor) -> torch.Tensor:
    """Segment sums along the last axis of a contiguous ``(3, NW, *batch,
    n)`` tensor -> keeps a unit last axis: one segmented kernel call
    (:func:`.kernels.point_reduce`), for every point sum of the MSM layer
    and the range prover."""
    return kernels.point_reduce(pts)


def _scan_lanes_hs(pts4: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis of ``(3, NW, W, m)`` by
    Hillis-Steele: log2(m) full-width adds."""
    m = pts4.shape[-1]
    sh = 1
    while sh < m:
        ident = identity((*pts4.shape[2:-1], sh), pts4.device)
        shifted = torch.cat([ident, pts4[..., :-sh]], dim=-1)
        pts4 = _add(pts4, shifted)
        sh *= 2
    return pts4


# ---------------------------------------------------------------------------
# bucket phase
# ---------------------------------------------------------------------------

def _chunk_shape(W: int, n: int) -> tuple[int, int]:
    """(chunks per window nt, steps T): lanes ``W nt`` up to _SCAN_LANES,
    ``T = ceil(n / nt)`` steps of the prefix scan."""
    nt = 1
    while W * nt * 2 <= _SCAN_LANES and nt * 2 <= n:
        nt *= 2
    return nt, -(-n // nt)


def _window_group(W: int, n: int, budget_lanes: int = 1 << 23) -> int:
    """Windows per bucket phase: the largest divisor of W with ``Wg n`` at
    most ``budget_lanes`` (bounds the sorted-point and prefix tensors)."""
    budget = max(1, budget_lanes // n)
    return max(d for d in range(1, W + 1) if W % d == 0 and d <= budget)


def _bucket_sums_tail(cums: torch.Tensor, total: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``(3, NW, W, B-1)`` boundary prefixes -> ``(W, 3, NW)`` window sums:
    ``sum_t (total - cum_t)`` with empty boundaries as the identity."""
    cums = _point_select(~valid, identity(cums.shape[2:], cums.device), cums)
    s_vals = _add(total[..., None].expand(cums.shape), _point_neg(cums))
    return _reduce_sum(s_vals)[..., 0].permute(2, 0, 1)


def _windowed_bucket_sums_prelaid(x: torch.Tensor, pos: torch.Tensor, W: int, nt: int,
                                  T: int) -> torch.Tensor:
    """Bucket phase over a ``(3, NW, T, W nt)`` tensor (sorted position
    ``p = chunk T + step``, identity-padded to ``nt T``)."""
    valid = pos >= 0
    posc = pos.clamp(min=0)
    prefix = kernels.point_scan_steps_inner(x.contiguous())
    prefix5 = prefix.reshape(3, NW, T, W, nt)
    cum = _scan_lanes_hs(prefix5[:, :, -1])        # (3, NW, W, nt) chunk prefix
    total = cum[..., -1]                           # (3, NW, W)
    offex = torch.cat([identity((W, 1), x.device), cum[..., :-1]], dim=-1)
    cpos, r = posc // T, posc % T
    w_col = torch.arange(W, device=x.device)[:, None]
    within = prefix5[:, :, r, w_col, cpos]         # (3, NW, W, B-1)
    offsel = offex[:, :, w_col, cpos]
    return _bucket_sums_tail(_add(within, offsel), total, valid)


def _horner_windows(window_sums: torch.Tensor, c: int) -> torch.Tensor:
    """``(nw, 3, NW)`` window sums -> ``(3, NW)``: c doublings and one add per
    window, in one Horner kernel."""
    return kernels.point_horner_multi(window_sums[..., None].contiguous(), c)[..., 0]


def _bucket_sums_fetch_prelaid(table, ident_idx: int, rec_g, neg_g, pos, W: int, n: int):
    """Gather table records straight into the scan layout: the int64 index
    and sign arrays are transposed, never the point tensor."""
    nt, T = _chunk_shape(W, n)
    if nt * T != n:
        pad = nt * T - n
        rec_g = torch.cat([rec_g, rec_g.new_full((W, pad), ident_idx)], dim=-1)
        neg_g = torch.cat([neg_g, neg_g.new_zeros((W, pad))], dim=-1)
    rec_t = rec_g.reshape(W, nt, T).permute(2, 0, 1).reshape(-1)
    neg_t = neg_g.reshape(W, nt, T).permute(2, 0, 1).reshape(-1)
    pts = _fetch(table, rec_t)
    pts = _point_select(neg_t != 0, _point_neg(pts), pts)
    return _windowed_bucket_sums_prelaid(pts.reshape(3, NW, T, W * nt), pos, W, nt, T)


# ---------------------------------------------------------------------------
# variable-base MSMs
# ---------------------------------------------------------------------------

def select_window(n: int, bits: int = FIELD_BITS) -> int:
    """Signed-digit window size for an ``n``-point MSM of ``bits``-bit
    scalars: c = 9 for the 64-bit split chunks, else the c in 5..16 that
    minimizes ``windows (n + 2^c)`` and whose top window stays in the
    signed bucket range.  The JAX package's choice, kept so both packages
    run the same windows."""
    if bits == SPLIT_CHUNK_BITS:
        return SPLIT_WINDOW
    best_c, best_cost = 5, None
    for c in range(5, 17):
        top_width = bits - (bits // c) * c if bits % c else c
        if top_width > c - 2:
            continue
        cost = -(-bits // c) * (n + (1 << c))
        if best_cost is None or cost < best_cost:
            best_c, best_cost = c, cost
    return best_c


def _msm_device_impl(scalars: torch.Tensor, points: torch.Tensor, c: int | None = None,
                     bits: int = FIELD_BITS) -> torch.Tensor:
    """MSM of ``(NW, n)`` scalars over ``(3, NW, n)`` points -> ``(3, NW)``.

    One sort of every window's ``|digit|``, then per group of
    :func:`_window_group` windows the records come from ``[points |
    identity]`` straight into the scan layout, padded with the identity."""
    n = scalars.shape[-1]
    if c is None:
        c = select_window(n, bits)
    d_sorted, order, negs = _sort_digits(_signed_digits(scalars, c, bits))
    nw = d_sorted.shape[0]
    wg = _window_group(nw, n)
    table = torch.cat([points, identity((1,), points.device)], dim=-1)
    wins = [_bucket_sums_fetch_prelaid(table, n, order[g : g + wg], negs[g : g + wg],
                                       _boundaries(d_sorted[g : g + wg], c), wg, n)
            for g in range(0, nw, wg)]
    return _horner_windows(torch.cat(wins), c)


def msm_device(scalars: torch.Tensor, points: torch.Tensor, c: int | None = None) -> torch.Tensor:
    """``sum_i s_i P_i`` over ``(NW, n)`` canonical scalars (< 2^252) and
    ``(3, NW, n)`` projective points on one device -> ``(3, NW)``."""
    if scalars.dim() != 2 or scalars.shape[0] != NW:
        raise ValueError("msm_device: expected (NW, n) scalars")
    if tuple(points.shape) != (3, NW, scalars.shape[-1]):
        raise ValueError("msm_device: expected (3, NW, n) points matching the scalars")
    if points.device != scalars.device:
        raise ValueError("msm_device: scalars and points on different devices")
    if scalars.shape[-1] == 0:
        return identity((), points.device).contiguous()
    return _msm_device_impl(scalars, points.contiguous(), c)


def msm_device_pair(sA: torch.Tensor, pA: torch.Tensor, sB: torch.Tensor, pB: torch.Tensor,
                    c: int, bits: int = FIELD_BITS) -> torch.Tensor:
    """Two same-width MSMs as one -> ``(3, NW, 2)``: ``sum sA_i pA_i`` and
    ``sum sB_i pB_i`` over ``(NW, n)`` scalars and ``(3, NW, n)`` points.

    One sort of both MSMs' windows side by side, one bucket phase and one
    Horner chain with both outputs on the lane axis, against the table
    ``[pA | pB | identity]`` (:func:`_msm_multi_table_impl`).  A ``c`` whose
    top window is full at ``bits`` raises ``ValueError``."""
    n = sA.shape[-1]
    for s, p in ((sA, pA), (sB, pB)):
        if s.dim() != 2 or s.shape[0] != NW or s.shape[-1] != n:
            raise ValueError("msm_device_pair: expected two (NW, n) scalar tensors of one width")
        if tuple(p.shape) != (3, NW, n) or p.device != sA.device or s.device != sA.device:
            raise ValueError("msm_device_pair: expected (3, NW, n) points beside the scalars")
    table = torch.cat([pA, pB, identity((1,), pA.device)], dim=-1).contiguous()
    rec = torch.arange(n, device=pA.device)
    return _msm_multi_table_impl([(sA, rec), (sB, rec + n)], table, c, bits)


def msm_device_split(scalars: torch.Tensor, points4: torch.Tensor, c: int | None = None) -> torch.Tensor:
    """MSM of ``(NW, n)`` scalars against a pre-shifted ``(3, NW, 4n)`` table
    (:func:`split_points_device`) -> ``(3, NW)``: the scalars' 64-bit chunks
    (:func:`split_scalars_device`) in windows of
    ``select_window(4n, 64)`` bits."""
    s4 = split_scalars_device(scalars)
    if tuple(points4.shape) != (3, NW, s4.shape[-1]):
        raise ValueError("msm_device_split: expected a (3, NW, 4n) split table")
    if c is None:
        c = select_window(s4.shape[-1], SPLIT_CHUNK_BITS)
    return _msm_device_impl(s4, points4.contiguous(), c, SPLIT_CHUNK_BITS)


def msm_host_points(scalars, points, c: int | None = None, *, device="cuda"):
    """Host scalars (``Scalar`` or ints in ``[0, r)``) and host ``StarkPoint``s
    -> ``StarkPoint``, computed by :func:`msm_device` on ``device`` (the card
    unless the caller asks for the CPU).  ``points`` may also be a ``(3, NW,
    n)`` point tensor already on the device (cached generators)."""
    s, p = device_operands(scalars, points, resolve_device(device))
    return curve_t.points_to_host(msm_device(s, p, c)[..., None])[0]


def device_operands(scalars, points, device: torch.device):
    """Host scalars, and host points or a point tensor -> ``(NW, n)``
    scalars and ``(3, NW, n)`` points on ``device``."""
    s = torch.as_tensor(curve_t.scalars_from_host(scalars), device=device)
    if isinstance(points, torch.Tensor):
        return s, points.to(device)
    return s, torch.as_tensor(curve_t.points_from_host(points), device=device)


# ---------------------------------------------------------------------------
# split-table MSMs
# ---------------------------------------------------------------------------

def split_scalars_device(scalars: torch.Tensor) -> torch.Tensor:
    """``(NW, n)`` -> ``(NW, 4n)``: lane ``j n + i`` holds 64-bit chunk j of
    scalar i in word 0 (block-major, matching the table's shift blocks)."""
    n = scalars.shape[-1]
    out = scalars.new_zeros((NW, SPLIT_CHUNKS * n))
    out[0] = scalars.reshape(-1)
    return out


def split_record_indices(base_idx: np.ndarray, n_table: int) -> np.ndarray:
    """Lane ``b k + i`` reads record ``b n_table + base_idx[i]``."""
    blocks = np.arange(SPLIT_CHUNKS, dtype=np.int64)[:, None] * n_table
    return (blocks + base_idx[None, :].astype(np.int64)).reshape(-1)


def split_points_device(points: torch.Tensor) -> torch.Tensor:
    """``(3, NW, n)`` -> ``(3, NW, 4n)`` blocks ``[P | 2^64 P | 2^128 P | 2^192 P]``
    by 192 full-width doublings."""
    blocks = [points.contiguous()]
    for _ in range(SPLIT_CHUNKS - 1):
        p = blocks[-1]
        for _ in range(SPLIT_CHUNK_BITS):
            p = kernels.point_add(p, p)
        blocks.append(p)
    return torch.cat(blocks, dim=-1)


def build_split_affine_table(points: torch.Tensor) -> torch.Tensor:
    """``(3, NW, n)`` bases -> ``(3, NW, 4n + 1)`` affine split table with a
    trailing identity record (the bucket fetch pads with it)."""
    aff = to_affine_mont(split_points_device(points))
    return torch.cat([aff, identity((1,), points.device)], dim=-1).contiguous()


def _msm_multi_table_impl(parts, table: torch.Tensor, c: int,
                          bits: int = SPLIT_CHUNK_BITS) -> torch.Tensor:
    """``k`` same-width MSMs against one table -> ``(3, NW, k)``.

    ``parts``: list of ``(scalars, recs)``, ``(NW, n)`` ``bits``-bit scalars
    and the ``(n,)`` table records of their points; the table's last record
    is the identity.  The k MSMs share one sort, one bucket phase (their
    windows side by side) and one Horner combine with the k outputs on the
    lane axis.  The range prover runs it on 64-bit chunks against the split
    table; the general IPP prover runs each round's L/R pair on 252-bit
    scalars against ``[G | H | Q | identity]`` (the JAX package's
    ``_msm_batched_pair_impl``)."""
    k = len(parts)
    n = parts[0][0].shape[-1]
    digits = torch.cat([_signed_digits(s, c, bits) for s, _ in parts])  # (k nw, n)
    nw = digits.shape[0] // k
    d_sorted, order, negs = _sort_digits(digits)
    rec_stack = torch.stack([r for _, r in parts])                        # (k, n)
    recs = torch.gather(rec_stack.repeat_interleave(nw, dim=0), 1, order)

    W = k * nw
    wg = _window_group(W, n)
    wins = []
    for g in range(0, W, wg):
        pos = _boundaries(d_sorted[g : g + wg], c)
        wins.append(_bucket_sums_fetch_prelaid(
            table, table.shape[-1] - 1, recs[g : g + wg], negs[g : g + wg], pos, wg, n))
    wins = torch.cat(wins)                                                # (W, 3, NW)
    multi = torch.stack([wins[i * nw : (i + 1) * nw] for i in range(k)], dim=-1)
    return kernels.point_horner_multi(multi.contiguous(), c)


# ---------------------------------------------------------------------------
# fixed-base tables
# ---------------------------------------------------------------------------

def fixed_base_table(base_pt: torch.Tensor) -> torch.Tensor:
    """``(3, NW, 1)`` point -> ``(3, NW, FB_WINDOWS FB_TABLE)`` affine table,
    record ``w 256 + d`` = ``d 2^(8 w) B``.

    The 32 window bases ``2^(8 w) B`` come from 248 doublings of one point;
    then all windows' multiples grow together by doubling concatenation,
    ``[0, 2k) = [0, k) ++ ([0, k) + k)``, eight wide adds."""
    p = base_pt.contiguous()
    bases = [p]
    for _ in range(FB_WINDOWS - 1):
        for _ in range(FB_WINDOW_BITS):
            p = kernels.point_add(p, p)
        bases.append(p)
    col = torch.cat(bases, dim=-1)[..., None]                    # (3, NW, 32, 1)
    rows = torch.cat([identity((FB_WINDOWS, 1), base_pt.device), col], dim=-1)
    step = col.contiguous()
    while rows.shape[-1] < FB_TABLE:
        step = kernels.point_add(step, step)                     # k 2^(8w) B
        rows = torch.cat([rows, _add(rows, step.expand(rows.shape))], dim=-1)
    return to_affine_mont(rows.reshape(3, NW, FB_WINDOWS * FB_TABLE)).contiguous()


def _fb_digits(scalars: torch.Tensor) -> torch.Tensor:
    """``(NW, k)`` words -> ``(FB_WINDOWS, k)`` 8-bit digits, LSB window first."""
    return torch.stack([_bits_at(scalars, FB_WINDOW_BITS * w, FB_WINDOW_BITS)
                        for w in range(FB_WINDOWS)])


def fixed_commit(table: torch.Tensor, base_off_l: torch.Tensor, sc_l: torch.Tensor,
                 base_off_r: torch.Tensor, sc_r: torch.Tensor) -> torch.Tensor:
    """Batched two-base commitment ``sc_l base_l + sc_r base_r`` -> ``(3, NW, k)``.

    ``table`` concatenates per-base :func:`fixed_base_table` tables;
    ``base_off_*`` ``(k,)`` are each lane's table offset (multiples of
    ``FB_WINDOWS FB_TABLE``); ``sc_*`` ``(NW, k)`` scalars."""
    w_off = torch.arange(FB_WINDOWS, dtype=torch.int64, device=sc_l.device)[:, None] * FB_TABLE
    idx_l = base_off_l[None, :] + w_off + _fb_digits(sc_l)
    idx_r = base_off_r[None, :] + w_off + _fb_digits(sc_r)
    # the index array is transposed, not the points: (3, NW, k, 64), windows last
    return _reduce_sum(_fetch(table, torch.cat([idx_l, idx_r]).T))[..., 0]
