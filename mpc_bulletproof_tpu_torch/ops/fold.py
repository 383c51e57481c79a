"""The IPP's per-round witness and generator folds on tensors.

The port's copy of the JAX package's ``ops/fold.py``.  Given a round
challenge ``u``, the classic prover folds

    a' = u a_L + u^-1 a_R            (scalar-field vectors)
    b' = u^-1 b_L + u b_R
    G' = u^-1 G_L + u G_R            (a two-point product per element)
    H' = u H_L + u^-1 H_R

Scalar folds are two products and a sum on the word layer (:mod:`.limb`).
Point folds are a joint double-and-add (Shamir's trick), most significant
bit first: per bit one doubling of every lane and one addition of a 4-way
selected addend ``{identity, G_L, G_R, G_L + G_R}``, both launches of the
``point_add`` kernel (:func:`.kernels.point_add`; on CPU tensors its plain
version), the select in plain torch.  252 bits give 504 launches plus one
for ``G_L + G_R``.  The bits are data, ``(252, h)``, so per-element
scalars (the first round's ``G_factors`` / ``H_factors``) take the same
path as one shared pair broadcast to every lane.
"""

from __future__ import annotations

import torch

from ..constants import FIELD_BITS
from . import kernels
from .curve_t import _point_select, identity
from .limb import FR, NW, ModParams, mod_add, mod_mul


def scalar_bits(x: torch.Tensor) -> torch.Tensor:
    """``(NW, h)`` words -> ``(FIELD_BITS, h)`` bits (int64), LSB first."""
    rows = [(x[i] >> j) & 1 for i in range(NW) for j in range(64)]
    return torch.stack(rows[:FIELD_BITS], dim=0)


def fold_scalars(u: torch.Tensor, u_inv: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                 mp: ModParams = FR) -> torch.Tensor:
    """``u left + u_inv right`` for ``(NW, h)`` vectors; ``u`` and ``u_inv``
    are ``(NW, 1)``."""
    return mod_add(mod_mul(left, u, mp), mod_mul(right, u_inv, mp), mp)


def _fold(bits_l: torch.Tensor, bits_r: torch.Tensor, G_L: torch.Tensor, G_R: torch.Tensor,
          add) -> torch.Tensor:
    """:func:`fold_points` with the point addition ``add``."""
    h = G_L.shape[-1]
    G_L, G_R = G_L.contiguous(), G_R.contiguous()
    both = add(G_L, G_R)
    ident = identity((h,), G_L.device)
    acc = ident.contiguous()
    for row in range(bits_l.shape[0] - 1, -1, -1):
        acc = add(acc, acc)
        sel = bits_l[row] + 2 * bits_r[row]
        addend = _point_select(sel == 3, both, ident)
        addend = _point_select(sel == 1, G_L, addend)
        addend = _point_select(sel == 2, G_R, addend)
        acc = add(acc, addend.contiguous())
    return acc


def fold_points(bits_l: torch.Tensor, bits_r: torch.Tensor, G_L: torch.Tensor,
                G_R: torch.Tensor) -> torch.Tensor:
    """``s_l G_L + s_r G_R`` per element.

    ``bits_l``, ``bits_r``: ``(B, h)`` bits of the scalars, LSB first (``B =
    FIELD_BITS`` for full scalars; may be expanded from one shared scalar).
    ``G_L``, ``G_R``: ``(3, NW, h)`` points on one device -> ``(3, NW, h)``."""
    if G_L.shape != G_R.shape or G_L.dim() != 3 or tuple(G_L.shape[:2]) != (3, NW):
        raise ValueError("fold_points: expected two (3, NW, h) point batches")
    h = G_L.shape[-1]
    if bits_l.shape != bits_r.shape or bits_l.dim() != 2 or bits_l.shape[-1] != h:
        raise ValueError("fold_points: expected (B, h) bit rows matching the points")
    return _fold(bits_l, bits_r, G_L, G_R, kernels.point_add)


def fold_points_shared(u_l: torch.Tensor, u_r: torch.Tensor, G_L: torch.Tensor,
                       G_R: torch.Tensor) -> torch.Tensor:
    """:func:`fold_points` with one ``(NW, 1)`` scalar pair for every lane."""
    h = G_L.shape[-1]
    bl = scalar_bits(u_l).expand(FIELD_BITS, h)
    br = scalar_bits(u_r).expand(FIELD_BITS, h)
    return fold_points(bl, br, G_L, G_R)
