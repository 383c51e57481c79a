"""Keccak-256 (pre-NIST padding, "Ethereum keccak"), on the host.

The Fiat-Shamir transcript and the generator chains are keccak256 hash
chains: rate 136 bytes, capacity 512, padding ``0x01 .. 0x80`` (not the
NIST SHA3 ``0x06``).  :func:`keccak256` is the pure-Python reference;
:func:`keccak256_batch` hashes many one-block messages at once with numpy
``uint64`` lanes (the generator chains walk 2m chains side by side; the
R1CS prover's RNG draws its counter blocks together).
"""

from __future__ import annotations

import numpy as np

_MASK = (1 << 64) - 1

# Round constants for Keccak-f[1600].
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# Rotation offsets, indexed [x][y].
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_RATE = 136  # bytes; Keccak-256 rate


def _rol(value: int, shift: int) -> int:
    return ((value << shift) | (value >> (64 - shift))) & _MASK


def keccak_f1600(lanes: list[int]) -> list[int]:
    """One Keccak-f[1600] permutation over 25 uint64 lanes (x + 5*y order)."""
    a = lanes
    for rc in _RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(a[x + 5 * y], _ROT[x][y])
        a = [
            b[i] ^ ((~b[(i + 1) % 5 + 5 * (i // 5)]) & _MASK) & b[(i + 2) % 5 + 5 * (i // 5)]
            for i in range(25)
        ]
        a[0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    """Keccak-256 digest (original padding 0x01) of ``data``."""
    state = [0] * 25
    padded = bytearray(data)
    padded += b"\x00" * (_RATE - (len(padded) % _RATE))
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80
    for off in range(0, len(padded), _RATE):
        block = padded[off : off + _RATE]
        for i in range(_RATE // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        state = keccak_f1600(state)
    return b"".join(state[i].to_bytes(8, "little") for i in range(4))


def pad_label(label: bytes) -> bytes:
    """Zero-pad a transcript label to the next multiple of 32 bytes."""
    return label + b"\x00" * ((-len(label)) % 32)


# -- batched keccak over numpy uint64 lanes --------------------------------

_ROT_NP = np.array([_ROT[i % 5][i // 5] for i in range(25)], dtype=np.uint64)
_PI_SRC = np.zeros(25, dtype=np.int64)
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
_CHI_1 = np.array([(i % 5 + 1) % 5 + 5 * (i // 5) for i in range(25)])
_CHI_2 = np.array([(i % 5 + 2) % 5 + 5 * (i // 5) for i in range(25)])
_RC_NP = np.array(_RC, dtype=np.uint64)


def _rotl_np(a: np.ndarray, r: np.ndarray) -> np.ndarray:
    r = r.reshape((-1,) + (1,) * (a.ndim - 1))
    return (a << r) | (a >> ((np.uint64(64) - r) % np.uint64(64)))


def _keccak_f1600_np(a: np.ndarray) -> np.ndarray:
    """Keccak-f[1600] over ``(25, k)`` uint64 lanes (k independent states)."""
    one = np.ones(5, dtype=np.uint64)
    for rnd in range(24):
        c = a[0:5] ^ a[5:10] ^ a[10:15] ^ a[15:20] ^ a[20:25]
        d = np.roll(c, 1, axis=0) ^ _rotl_np(np.roll(c, -1, axis=0), one)
        a = a ^ np.tile(d, (5, 1))
        b = _rotl_np(a, _ROT_NP)[_PI_SRC]
        a = b ^ (~b[_CHI_1] & b[_CHI_2])
        a[0] ^= _RC_NP[rnd]
    return a


def keccak256_batch(msgs: np.ndarray) -> np.ndarray:
    """Keccak-256 of ``k`` messages of one length ``L < 136`` bytes (one
    block each): ``(k, L)`` uint8 -> ``(k, 32)``."""
    k, length = msgs.shape
    if length >= _RATE:
        raise ValueError("keccak256_batch: messages must fit one block")
    block = np.zeros((k, _RATE), dtype=np.uint8)
    block[:, :length] = msgs
    block[:, length] ^= 0x01
    block[:, _RATE - 1] ^= 0x80
    a = np.zeros((25, k), dtype=np.uint64)
    a[0 : _RATE // 8] = block.view("<u8").T
    a = _keccak_f1600_np(a)
    return np.ascontiguousarray(a[0:4].T.astype("<u8")).view(np.uint8).reshape(k, 32)


def keccak256_batch32(msgs: np.ndarray) -> np.ndarray:
    """Keccak-256 of ``k`` 32-byte messages: ``(k, 32)`` uint8 -> ``(k, 32)``."""
    return keccak256_batch(np.ascontiguousarray(msgs, dtype=np.uint8))
