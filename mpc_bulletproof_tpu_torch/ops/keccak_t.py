"""Keccak-256 on tensors, for the fused prover's on-card Fiat-Shamir transcript.

Mirrors :mod:`.keccak` bit for bit: keccak-f[1600] and keccak-256 with the
original padding ``0x01 .. 0x80``.  The state is a ``(25,)`` int64 tensor
of 64-bit lanes (index ``x + 5 y``); int64 is signed, so every right shift
in a rotation is masked to the bits it brings in.  Messages are ``(len,)``
int64 byte tensors of a length known to the caller; every transcript
absorb of the protocol fits one block (at most 135 bytes), so only that
path exists.
"""

from __future__ import annotations

import numpy as np
import torch

from .keccak import _RC, _ROT
from .limb import _const

RATE = 136  # keccak-256 rate in bytes (17 lanes)

_ROT_LANE = np.array([_ROT[i % 5][i // 5] for i in range(25)], dtype=np.int64)
_PI_SRC = np.zeros(25, dtype=np.int64)
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
_CHI_1 = np.array([(i % 5 + 1) % 5 + 5 * (i // 5) for i in range(25)], dtype=np.int64)
_CHI_2 = np.array([(i % 5 + 2) % 5 + 5 * (i // 5) for i in range(25)], dtype=np.int64)
_TH_M1 = np.array([(x - 1) % 5 for x in range(5)], dtype=np.int64)
_TH_P1 = np.array([(x + 1) % 5 for x in range(5)], dtype=np.int64)
# iota as a (24, 25) xor mask: round constant in lane 0, zeros elsewhere
_IOTA = np.zeros((24, 25), dtype=np.int64)
_IOTA[:, 0] = np.array(_RC, dtype=np.uint64).view(np.int64)


def _tables(device):
    def make():
        rot = torch.as_tensor(_ROT_LANE)
        return torch.stack([
            rot, 63 - rot, (1 << rot) - 1,
            torch.as_tensor(_PI_SRC), torch.as_tensor(_CHI_1), torch.as_tensor(_CHI_2),
        ])
    return _const("keccak", device, make)


def _rotl(a: torch.Tensor, r, r_inv, mask) -> torch.Tensor:
    """Rotate 64-bit lanes left by ``r`` in [0, 63] (``r_inv = 63 - r``,
    ``mask = 2^r - 1``): the bits leaving at the top come back masked."""
    return (a << r) | (((a >> 1) >> r_inv) & mask)


def keccak_f1600(a: torch.Tensor) -> torch.Tensor:
    """One permutation of a ``(25,)`` int64 lane state."""
    dev = a.device
    rot, rot_inv, rot_mask, pi, chi1, chi2 = _tables(dev)
    th_m1 = _const("keccak_thm1", dev, lambda: torch.as_tensor(_TH_M1))
    th_p1 = _const("keccak_thp1", dev, lambda: torch.as_tensor(_TH_P1))
    iota = _const("keccak_iota", dev, lambda: torch.as_tensor(_IOTA))
    for rnd in range(24):
        g = a.reshape(5, 5)  # [y, x]
        c = g[0] ^ g[1] ^ g[2] ^ g[3] ^ g[4]
        cp = c[th_p1]
        d = c[th_m1] ^ ((cp << 1) | ((cp >> 63) & 1))
        a = (g ^ d[None, :]).reshape(25)
        b = _rotl(a, rot, rot_inv, rot_mask)[pi]
        a = b ^ (~b[chi1] & b[chi2]) ^ iota[rnd]
    return a


def keccak256(data: torch.Tensor, length: int) -> torch.Tensor:
    """keccak-256 of a ``(length,)`` int64 byte tensor -> ``(32,)`` bytes."""
    if length > RATE - 1:
        raise ValueError("single-block keccak only: message longer than 135 bytes")
    if data.shape != (length,):
        raise ValueError("keccak256: data length mismatch")
    block = torch.zeros(RATE, dtype=torch.int64, device=data.device)
    block[:length] = data
    block[length] = 0x01
    block[RATE - 1] |= 0x80
    sh = _const("keccak_sh8", data.device, lambda: torch.arange(0, 64, 8, dtype=torch.int64))
    lanes = (block.reshape(17, 8) << sh).sum(dim=1)  # disjoint bits: sum == or
    a = torch.cat([lanes, lanes.new_zeros(8)])
    a = keccak_f1600(a)
    return ((a[:4, None] >> sh) & 0xFF).reshape(32)
