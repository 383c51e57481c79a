"""Keccak-256 on tensors: the fused prover's on-card Fiat-Shamir transcript,
and the plain versions of the generator chains' keccak kernels.

Mirrors :mod:`.keccak` bit for bit: keccak-f[1600] and keccak-256 with the
original padding ``0x01 .. 0x80``.  A state is a ``(25, *batch)`` int64
tensor of 64-bit lanes (index ``x + 5 y``); int64 is signed, so every right
shift in a rotation is masked to the bits it brings in.  Every transcript
absorb of the protocol fits one block (at most 135 bytes), so only that
path exists.  :func:`keccak_chain_plain` and :func:`keccak256_32_plain`
take ``(k, 32)`` uint8 byte rows, and :func:`keccak_transcript_plain` runs
of transcript blocks as 64-bit words: the plain versions of
``csrc/keccak.cu`` (wrappers in :mod:`.kernels`).
"""

from __future__ import annotations

import numpy as np
import torch

from .keccak import _RC, _ROT
from .limb import FR, _const, reduce_512, to_pieces

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
    """One permutation of a ``(25, *batch)`` int64 lane state."""
    dev, shape = a.device, a.shape
    a = a.reshape(25, -1)
    rot, rot_inv, rot_mask, pi, chi1, chi2 = _tables(dev)
    rot, rot_inv, rot_mask = rot[:, None], rot_inv[:, None], rot_mask[:, None]
    th_m1 = _const("keccak_thm1", dev, lambda: torch.as_tensor(_TH_M1))
    th_p1 = _const("keccak_thp1", dev, lambda: torch.as_tensor(_TH_P1))
    iota = _const("keccak_iota", dev, lambda: torch.as_tensor(_IOTA))[:, :, None]
    for rnd in range(24):
        g = a.reshape(5, 5, -1)  # [y, x, batch]
        c = g[0] ^ g[1] ^ g[2] ^ g[3] ^ g[4]
        cp = c[th_p1]
        d = c[th_m1] ^ ((cp << 1) | ((cp >> 63) & 1))
        a = (g ^ d[None]).reshape(25, -1)
        b = _rotl(a, rot, rot_inv, rot_mask)[pi]
        a = b ^ (~b[chi1] & b[chi2]) ^ iota[rnd]
    return a.reshape(shape)


def _hash_block(block: torch.Tensor) -> torch.Tensor:
    """keccak256 of one padded ``(136,)`` int64 byte block -> ``(32,)`` bytes."""
    sh = _const("keccak_sh8", block.device, lambda: torch.arange(0, 64, 8, dtype=torch.int64))
    lanes = (block.reshape(17, 8) << sh).sum(dim=1)  # disjoint bits: sum == or
    a = keccak_f1600(torch.cat([lanes, lanes.new_zeros(8)]))
    return ((a[:4, None] >> sh) & 0xFF).reshape(32)


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
    return _hash_block(block)


def keccak_transcript_plain(starts: torch.Tensor, template: torch.Tensor, layout: torch.Tensor,
                            msgs: torch.Tensor, challenges: int):
    """Runs of transcript blocks, the plain version of ``bp_keccak_transcript``.

    ``starts`` ``(T, 4)`` words, one state a transcript; ``template``
    ``(J, 17)`` words, block ``i``'s label, host constants and padding
    (words 0-3 are not read: the running state takes their place);
    ``layout`` ``(J, 4)``, block ``i``'s first message word's position,
    its message's words, their offset in a message row, and 1 for a
    challenge; ``msgs`` ``(T, W)`` words, one row a transcript.  Every
    block is ``state <- keccak256(block)``; at a challenge the new state
    ``s`` also gives ``LE(s || keccak256(s)) mod r``.  Returns the final
    states ``(T, 4)`` and the ``challenges`` challenges ``(T, NW, C)`` in
    run order, canonical words."""
    state = starts.T                                           # (4, T)
    squeezed = []
    for i, (pos, n, off, chal) in enumerate(layout.tolist()):
        a = state.new_zeros((25, state.shape[1]))
        a[:4] = state
        a[4:RATE // 8] = template[i, 4:, None]
        a[pos : pos + n] |= msgs[:, off : off + n].T
        state = keccak_f1600(a)[:4]
        if chal:
            squeezed.append(state)
    if len(squeezed) != challenges:
        raise ValueError(f"keccak_transcript: the layout has {len(squeezed)} challenges, not {challenges}")
    u = starts.new_zeros((starts.shape[0], 4, 0))
    if squeezed:
        s = torch.stack(squeezed, dim=-1).reshape(4, -1)       # (4, T C)
        words = torch.cat([s, _hash32_lanes(s)])               # (8, T C): s || keccak256(s)
        u = reduce_512(torch.cat([to_pieces(words[:4]), to_pieces(words[4:])]), FR)
        u = u.reshape(4, starts.shape[0], challenges).permute(1, 0, 2)
    return state.T.contiguous(), u.contiguous()


# -- the generator chains: 32-byte messages in (k, 32) uint8 rows ------------

_PAD_LANE_4 = 0x01                 # the padding byte after a 32-byte message
_PAD_LANE_16 = -(1 << 63)          # the final 0x80 in byte 135, as int64


def _lanes32(rows: torch.Tensor) -> torch.Tensor:
    """``(k, 32)`` uint8 -> ``(4, k)`` int64 little-endian lanes."""
    sh = _const("keccak_sh8", rows.device, lambda: torch.arange(0, 64, 8, dtype=torch.int64))
    return (rows.to(torch.int64).reshape(-1, 4, 8) << sh).sum(dim=-1).T  # disjoint bits: sum == or


def _rows32(lanes: torch.Tensor) -> torch.Tensor:
    """``(4, *batch)`` int64 lanes -> ``(*batch, 32)`` uint8 rows."""
    sh = _const("keccak_sh8", lanes.device, lambda: torch.arange(0, 64, 8, dtype=torch.int64))
    out = (lanes.movedim(0, -1)[..., None] >> sh) & 0xFF
    return out.reshape(*lanes.shape[1:], 32).to(torch.uint8)


def _hash32_lanes(m: torch.Tensor) -> torch.Tensor:
    """keccak256 of ``(4, k)`` message lanes -> ``(4, k)`` digest lanes."""
    a = m.new_zeros((25, m.shape[-1]))
    a[:4] = m
    a[4] = _PAD_LANE_4
    a[16] = _PAD_LANE_16
    return keccak_f1600(a)[:4]


def keccak256_32_plain(msgs: torch.Tensor) -> torch.Tensor:
    """keccak256 of each ``(N, 32)`` uint8 row -> ``(N, 32)``."""
    return _rows32(_hash32_lanes(_lanes32(msgs)))


def keccak_chain_plain(starts: torch.Tensor, skip: int, count: int) -> torch.Tensor:
    """Each ``(C, 32)`` start row walked ``skip`` steps of ``s <- keccak256(s)``
    unwritten, then ``count`` steps -> ``(C, count, 32)`` states."""
    s = _lanes32(starts)
    for _ in range(skip):
        s = _hash32_lanes(s)
    steps = []
    for _ in range(count):
        s = _hash32_lanes(s)
        steps.append(s)
    if not steps:
        return starts.new_zeros((starts.shape[0], 0, 32))
    return _rows32(torch.stack(steps, dim=-1))                 # (4, C, count) -> (C, count, 32)
