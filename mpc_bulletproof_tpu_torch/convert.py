"""Carry point and scalar arrays of the JAX package across to the port.

The JAX package keeps points as ``(3, NLZ=21, n)`` int32 arrays of 13-bit
limbs, each coordinate in Montgomery form with ``R = 2^273`` and possibly
lazy (a value below ``16 p``, limbs in ``[-1, 2^13]``), and scalars as
``(NL=20, n)`` canonical 13-bit limbs.  The port keeps ``(3, NW, n)`` /
``(NW, n)`` canonical 64-bit words with ``R = 2^256``.  Numpy and the
port's own constants only: the tests use this to hand both packages the
same generator arrays.  Like every entry point of the port, both functions
put their result on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import P
from .ops.limb import ints_to_words

_BITS = 13
_JAX_MONT_BITS = 13 * 21
_PORT_MONT_BITS = 256
# x 2^273 -> x 2^256: multiply by 2^-17 mod p
_RESCALE = pow(1 << (_JAX_MONT_BITS - _PORT_MONT_BITS), -1, P)


def _limb_values(arr: np.ndarray) -> list[int]:
    """``(L, k)`` signed limbs -> Python ints ``sum_i limb_i 2^(13 i)``."""
    a = np.asarray(arr).astype(object)
    weights = np.array([1 << (_BITS * i) for i in range(a.shape[0])], dtype=object)
    return [int(v) for v in weights @ a]


def points_from_jax(np_arr, device="cuda") -> torch.Tensor:
    """JAX ``(3, NLZ, n)`` lazy Montgomery points -> port ``(3, NW, n)``."""
    a = np.asarray(np_arr)
    if a.ndim != 3 or a.shape[0] != 3:
        raise ValueError("expected a (3, NLZ, n) point array")
    coords = [ints_to_words([v % P * _RESCALE % P for v in _limb_values(a[c])]) for c in range(3)]
    return torch.as_tensor(np.stack(coords), device=device)


def scalars_from_jax(np_arr, device="cuda") -> torch.Tensor:
    """JAX ``(NL, n)`` canonical limbs -> port ``(NW, n)`` words."""
    a = np.asarray(np_arr)
    if a.ndim != 2:
        raise ValueError("expected an (NL, n) limb array")
    return torch.as_tensor(ints_to_words(_limb_values(a)), device=device)
