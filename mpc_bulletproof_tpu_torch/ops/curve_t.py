"""Batched STARK-curve group arithmetic on tensors (the point layer).

Points are projective ``(X : Y : Z)`` tensors of shape ``(3, NW, ...)``
(int64 words, batch last) with every coordinate canonical (``< p``) in
Montgomery form ``x 2^256 mod p``.  The identity is ``(0 : 1_M : 0)`` with
``1_M = 2^256 mod p``.  Host conversion multiplies by ``2^256`` in Python
integers.

Addition is the complete formula of Renes-Costello-Batina 2016 (eprint
2015/1060, Algorithm 1, a = 1): 12 field products plus 2 by the constant
``3b``, correct for every input pair (identity, doubling, inverses) with no
branch.  Unlike the JAX package's lazy bounds, every intermediate here is
reduced to ``[0, p)``: on the card a conditional subtraction costs a few
instructions, and canonical values make the kernel and its plain version
agree bit for bit.  :func:`_point_add` is the plain version;
:func:`.kernels.point_add` is the entry point that launches the CUDA kernel
for tensors on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import ALPHA, BETA, P
from .limb import (
    FP,
    NW,
    from_pieces,
    ints_to_words,
    mod_add_p,
    mod_sub_p,
    mont_mul_p,
    to_pieces,
    words_to_ints,
    _const,
)

assert ALPHA == 1, "the formulas below use a = 1"

B3_MONT = (3 * BETA) * FP.mont_r % P  # 3b in Montgomery form
MONT_ONE = FP.mont_r


def identity(batch_shape, device) -> torch.Tensor:
    """The projective identity ``(0 : 1_M : 0)``, expanded to ``batch_shape``."""
    col = _const(
        "identity", device,
        lambda: torch.as_tensor(
            np.stack([ints_to_words([v]) for v in (0, MONT_ONE, 0)])
        ),
    )
    batch_shape = tuple(batch_shape)
    return col.reshape((3, NW) + (1,) * len(batch_shape)).expand((3, NW) + batch_shape)


def _point_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain complete addition (RCB16 Alg. 1, a = 1) over ``(3, NW, ...)``.

    Independent products are batched into one Montgomery product call (the
    14 products run as 3 calls), so the op count stays small on the CPU."""
    shape = torch.broadcast_shapes(p.shape, q.shape)
    p = p.expand(shape).reshape(3, NW, -1)
    q = q.expand(shape).reshape(3, NW, -1)
    N = p.shape[-1]
    X1, Y1, Z1 = (to_pieces(p[i]) for i in range(3))
    X2, Y2, Z2 = (to_pieces(q[i]) for i in range(3))
    cat = lambda *xs: torch.cat(xs, dim=-1)
    split = lambda x: torch.split(x, N, dim=-1)
    add = lambda a, b: mod_add_p(a, b, FP)
    sub = lambda a, b: mod_sub_p(a, b, FP)
    mul = lambda a, b: mont_mul_p(a, b, FP)
    b3 = _const("b3m", p.device, lambda: torch.as_tensor(ints_to_words([B3_MONT])))
    b3 = to_pieces(b3).expand(-1, N)

    xy1, xy2, xz1, xz2, yz1, yz2 = split(add(cat(X1, X2, X1, X2, Y1, Y2),
                                             cat(Y1, Y2, Z1, Z2, Z1, Z2)))
    t0, t1, t2, t3, t4, t5 = split(mul(cat(X1, Y1, Z1, xy1, xz1, yz1),
                                       cat(X2, Y2, Z2, xy2, xz2, yz2)))
    s01, s02, s12, t00 = split(add(cat(t0, t0, t1, t0), cat(t1, t2, t2, t0)))
    t3, t4, t5, t2m = split(sub(cat(t3, t4, t5, t0), cat(s01, s02, s12, t2)))
    X3, t4b = split(mul(cat(b3, b3), cat(t2, t4)))        # b3 t2, b3 t4
    Z3 = add(X3, t4)                                      # b3 t2 + a t4
    X3, Z3 = sub(t1, Z3), add(t1, Z3)
    t1 = add(add(t00, t0), t2)                            # 3 t0 + a t2
    t4 = add(t4b, t2m)                                    # b3 t4 + (t0 - a t2)
    Y3, u0, u1, u2, u3, u4 = split(mul(cat(X3, t1, t5, t3, t3, t5),
                                       cat(Z3, t4, t4, X3, t1, Z3)))
    Y3 = add(Y3, u0)
    X3 = sub(u2, u1)
    Z3 = add(u4, u3)
    out = torch.stack([from_pieces(X3), from_pieces(Y3), from_pieces(Z3)], dim=0)
    return out.reshape(shape)


def _point_neg(p: torch.Tensor) -> torch.Tensor:
    """``(X : -Y : Z)``."""
    y = to_pieces(p[1].reshape(NW, -1))
    neg = from_pieces(mod_sub_p(torch.zeros_like(y), y, FP)).reshape(p[1].shape)
    return torch.stack([p[0], neg, p[2]], dim=0)


def _point_select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-point select; ``cond`` has the batch shape."""
    return torch.where(cond[None, None], a, b)


# ---------------------------------------------------------------------------
# host <-> tensor conversion
# ---------------------------------------------------------------------------

def points_from_host(points) -> np.ndarray:
    """Host ``StarkPoint`` list -> ``(3, NW, n)`` Montgomery projective words."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt.is_identity():
            xs.append(0), ys.append(MONT_ONE), zs.append(0)
        else:
            xs.append(pt.x * MONT_ONE % P), ys.append(pt.y * MONT_ONE % P), zs.append(MONT_ONE)
    return np.stack([ints_to_words(xs), ints_to_words(ys), ints_to_words(zs)], axis=0)


def points_to_host(arr) -> list:
    """``(3, NW, ...)`` projective words -> host ``StarkPoint`` list (the
    Montgomery factors cancel in X/Z and Y/Z)."""
    from .curve import StarkPoint

    a = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    a = a.reshape(3, NW, -1)
    out = []
    for X, Y, Z in zip(words_to_ints(a[0]), words_to_ints(a[1]), words_to_ints(a[2])):
        if Z % P == 0:
            out.append(StarkPoint.identity())
        else:
            zinv = pow(Z, -1, P)
            out.append(StarkPoint(X * zinv % P, Y * zinv % P))
    return out


def scalars_from_host(scalars) -> np.ndarray:
    """Host ``Scalar`` list (or ints) -> ``(NW, n)`` words."""
    return ints_to_words([int(s) for s in scalars])


def scalars_to_host(arr) -> list:
    from .field import Scalar

    return [Scalar(v) for v in words_to_ints(arr)]


def to_affine_mont(pts: torch.Tensor) -> torch.Tensor:
    """``(3, NW, k)`` projective -> affine-or-identity points in Montgomery
    form with ``Z in {0, 1_M}`` (the :func:`points_from_host` invariant), so
    they can be gathered as table records (:mod:`.msm`).  One batched Fermat
    inversion (``kernels.mod_pow_static``)."""
    return affine_mont(pts)[0]


def affine_mont(pts: torch.Tensor):
    """:func:`to_affine_mont`'s points, and beside them the standard-form
    affine ``(x, y, is_id)`` they were made from (``(NW, k)`` coordinates)."""
    from . import transcript_t as tj
    from .limb import mont_mul

    x, y, is_id = tj.lazy_points_to_affine(pts)
    r2 = _const("fp_r2", pts.device, lambda: torch.as_tensor(ints_to_words([FP.r2])))
    ident = identity((pts.shape[-1],), pts.device)
    mont = torch.stack([mont_mul(x, r2, FP), mont_mul(y, r2, FP), ident[1]], dim=0)  # x R, y R
    return _point_select(is_id, ident, mont), x, y, is_id
