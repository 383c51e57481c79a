"""Field arithmetic on tensors for the STARK base field FP and scalar field FR.

Representation
--------------
A batch of field elements is an ``int64`` tensor of shape ``(NW, ...)``:
``NW = 4`` little-endian 64-bit words, limb-major with the batch last, so
neighbouring CUDA threads read neighbouring words.  Words hold raw uint64
bit patterns (a word with bit 63 set reads as negative in torch); every
value here is canonical, ``< m < 2^252``, so only words 0-2 can do so.

Scalars (FR) are kept in standard form.  Point coordinates (FP) are kept in
Montgomery form ``x * 2^256 mod p`` (see :mod:`.curve_t`); the kernels in
``csrc/`` use the same ``R = 2^256``.

Plain arithmetic
----------------
torch has no 64x64->128 multiply, so the plain versions here split words
into ``NP = 16`` pieces of 16 bits (products < 2^32, column sums < 2^37,
far inside int64), multiply by one broadcast product plus an
``index_add_`` over the anti-diagonals, and reduce with Montgomery REDC
(``R = 2^256``).  Exact carry normalization is a few shift-add sweeps
followed by one carry-lookahead step that packs the generate/propagate bits
of all limbs into one int64 and resolves every carry with a single integer
addition.  Results are canonical, so any two correct implementations agree
bit for bit: the CPU tests and ``chip_smoke.py`` compare with ``==``.

The small per-device constant tensors are cached (``_const``); nothing else
is module state.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..constants import P, R
from ..utils.device import normalize_device

NW = 4  # 64-bit words per element
PIECE_BITS = 16
NP = 16  # 16-bit pieces per element
MASK = (1 << PIECE_BITS) - 1
MONT_BITS = 256  # Montgomery R = 2^256 for both fields

_CONST: dict = {}


def _const(key, device, make):
    """Per-device cache of small constant tensors."""
    k = (key, normalize_device(device))
    t = _CONST.get(k)
    if t is None:
        t = make().to(device)
        _CONST[k] = t
    return t


# ---------------------------------------------------------------------------
# host <-> words conversion (numpy, exact)
# ---------------------------------------------------------------------------

def ints_to_words(values: Sequence[int]) -> np.ndarray:
    """Python ints in ``[0, 2^256)`` -> ``(NW, k)`` int64 word array."""
    k = len(values)
    if k == 0:
        return np.zeros((NW, 0), dtype=np.int64)
    buf = b"".join(int(v).to_bytes(8 * NW, "little") for v in values)
    return np.frombuffer(buf, dtype="<i8").reshape(k, NW).T.copy()


def words_to_ints(arr) -> list[int]:
    """``(NW, ...)`` word array (numpy or tensor) -> flattened Python ints."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.asarray(arr, dtype=np.int64).reshape(NW, -1)
    data = np.ascontiguousarray(a.T).astype("<i8").tobytes()
    w = 8 * NW
    return [int.from_bytes(data[j * w : (j + 1) * w], "little") for j in range(a.shape[1])]


def _int_pieces(x: int, n: int = NP) -> list[int]:
    return [(x >> (PIECE_BITS * i)) & MASK for i in range(n)]


class ModParams:
    """Static per-modulus constants (Python ints; tensors via :meth:`t`)."""

    def __init__(self, modulus: int):
        self.modulus = modulus
        rr = 1 << MONT_BITS
        self.mont_r = rr % modulus  # 1 in Montgomery form
        self.r2 = rr * rr % modulus
        self.r3 = rr * self.r2 % modulus
        self.m_prime = (-pow(modulus, -1, rr)) % rr
        self._host = {
            "m": _int_pieces(modulus),
            "m_prime": _int_pieces(self.m_prime),
            "m17": _int_pieces(modulus, 17),
            "neg17": _int_pieces((1 << (PIECE_BITS * 17)) - modulus, 17),
            "negm34": _int_pieces((1 << (PIECE_BITS * 34)) - (modulus << MONT_BITS), 34),
            "r2": _int_pieces(self.r2),
            "r3": _int_pieces(self.r3),
        }

    def t(self, name: str, device) -> torch.Tensor:
        """Constant as a ``(pieces, 1)`` int64 column on ``device``."""
        vals = self._host[name]
        return _const(
            (self.modulus, name), device,
            lambda: torch.tensor(vals, dtype=torch.int64).reshape(-1, 1),
        )

    def __repr__(self):
        return f"ModParams(0x{self.modulus:x})"


FP = ModParams(P)
FR = ModParams(R)


# ---------------------------------------------------------------------------
# words <-> pieces
# ---------------------------------------------------------------------------

def to_pieces(w: torch.Tensor) -> torch.Tensor:
    """``(NW, ...)`` words -> ``(NP, ...)`` 16-bit pieces."""
    sh = _const("sh4", w.device, lambda: torch.arange(0, 64, 16, dtype=torch.int64))
    sh = sh.reshape((1, 4) + (1,) * (w.dim() - 1))
    return ((w.unsqueeze(1) >> sh) & MASK).reshape((NP,) + tuple(w.shape[1:]))


def from_pieces(p: torch.Tensor) -> torch.Tensor:
    """Normalized ``(NP, ...)`` pieces -> ``(NW, ...)`` words."""
    q = p.reshape((NW, 4) + tuple(p.shape[1:]))
    return q[:, 0] | (q[:, 1] << 16) | (q[:, 2] << 32) | (q[:, 3] << 48)


# ---------------------------------------------------------------------------
# carry normalization
# ---------------------------------------------------------------------------

def _sweeps(bits: int) -> int:
    """Shift-add sweeps that bring limbs ``< 2^bits`` to ``[0, 2^16]``."""
    s = 0
    while bits > PIECE_BITS + 1:
        bits = max(PIECE_BITS, bits - PIECE_BITS) + 1
        s += 1
    return s + 1


def _normalize(t: torch.Tensor, L: int, bits: int) -> torch.Tensor:
    """Nonnegative limbs ``(K, N)``, each ``< 2^bits`` -> exact 16-bit limbs
    ``(L, N)`` of the value mod ``2^(16 L)`` (``L <= 60``).

    Sweeps bound every limb to ``[0, 2^16]``; then a limb generates a carry
    iff it equals 2^16 and passes one on iff it equals 2^16 - 1.  With G the
    generate bits and A the generate-or-pass bits packed one bit per limb,
    ``(A + G) ^ A ^ G`` has bit i set iff a carry enters limb i.
    """
    K = t.shape[0]
    if K > L:
        t = t[:L]
    elif K < L:
        t = torch.cat([t, t.new_zeros((L - K, t.shape[1]))], dim=0)
    for _ in range(_sweeps(bits)):
        c = t >> PIECE_BITS
        t = t & MASK
        t[1:] += c[:-1]
    ar = _const(("ar", L), t.device, lambda: torch.arange(L, dtype=torch.int64)[:, None])
    G = ((t >> PIECE_BITS) << ar).sum(0)
    A = (((t + 1) >> PIECE_BITS) << ar).sum(0)
    cin = (((A + G) ^ A ^ G)[None] >> ar) & 1
    return (t + cin) & MASK


def _mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of piece vectors ``(Ka, N) x (Kb, N)`` ->
    ``(Ka + Kb - 1, N)`` unnormalized columns (a batch of 1 broadcasts)."""
    ka, kb = a.shape[0], b.shape[0]
    prod = a.unsqueeze(1) * b.unsqueeze(0)
    prod = prod.reshape(ka * kb, prod.shape[-1])
    idx = _const(
        ("diag", ka, kb), a.device,
        lambda: (torch.arange(ka)[:, None] + torch.arange(kb)[None, :]).reshape(-1),
    )
    out = prod.new_zeros((ka + kb - 1, prod.shape[-1]))
    return out.index_add_(0, idx, prod)


def _pick(x: torch.Tensor, y: torch.Tensor, L: int, bits: int, flag_limb: int):
    """Normalize two same-shape limb tensors in ONE pass (side by side on the
    batch axis); returns ``(x_n, y_n, flag)`` with ``flag = y_n[flag_limb] != 0``."""
    n = x.shape[-1]
    both = _normalize(torch.cat([x, y], dim=-1), L, bits)
    return both[:, :n], both[:, n:], both[flag_limb : flag_limb + 1, n:] != 0


def _redc(T: torch.Tensor, mp: ModParams, bits: int) -> torch.Tensor:
    """Montgomery REDC: limbs ``(K <= 32, N)`` of a value ``T < m 2^256``,
    each limb ``< 2^bits`` (``bits <= 38``) -> canonical pieces of
    ``T 2^-256 mod m``.

    ``u = -T m^-1 mod 2^256`` needs only T's low 16 columns, unnormalized
    (they hold T mod 2^256 up to multiples of 2^256).  ``V = T + u m`` is
    then a multiple of 2^256 below ``2 m 2^256``; V and ``V - m 2^256``
    (offset by 2^544 to stay nonnegative) normalize together, and limb 34
    of the second says which of the two quotients is below m."""
    dev = T.device
    N = T.shape[-1]
    low = T[:NP] if T.shape[0] >= NP else torch.cat([T, T.new_zeros((NP - T.shape[0], N))])
    u = _normalize(_mul_wide(low, mp.t("m_prime", dev))[:NP], NP, bits + 20)
    um = _mul_wide(u, mp.t("m", dev))                       # (31, N) columns < 2^36
    V = torch.cat([um, um.new_zeros((3, N))])               # (34, N)
    V[: T.shape[0]] += T
    first, second, ge = _pick(V, V + mp.t("negm34", dev), 35, max(bits, 36) + 2, 34)
    return torch.where(ge, second[NP : 2 * NP], first[NP : 2 * NP])


# ---------------------------------------------------------------------------
# piece-level modular ops (canonical in, canonical out)
# ---------------------------------------------------------------------------

def mont_mul_p(a: torch.Tensor, b: torch.Tensor, mp: ModParams) -> torch.Tensor:
    """``a b 2^-256 mod m`` on pieces."""
    return _redc(_mul_wide(a, b), mp, 37)


def mod_mul_p(a: torch.Tensor, b: torch.Tensor, mp: ModParams) -> torch.Tensor:
    """``a b mod m`` on pieces (standard form: two REDCs, the second by R^2)."""
    return mont_mul_p(mont_mul_p(a, b, mp), mp.t("r2", a.device), mp)


def mod_add_p(a: torch.Tensor, b: torch.Tensor, mp: ModParams) -> torch.Tensor:
    """``s = a + b < 2m``: s and ``s - m + 2^272`` normalize together; limb 17
    of the second is set iff ``s >= m``."""
    s = a + b
    s = torch.cat([s, s.new_zeros((1, s.shape[-1]))])
    first, second, ge = _pick(s, s + mp.t("neg17", a.device), 18, PIECE_BITS + 2, 17)
    return torch.where(ge, second[:NP], first[:NP])


def mod_sub_p(a: torch.Tensor, b: torch.Tensor, mp: ModParams) -> torch.Tensor:
    """``d = a - b + 2^256`` carries into limb 16 iff ``a >= b``; otherwise
    ``d + m`` mod 2^256 is ``a - b + m``.  Both normalize together."""
    d = a + (MASK - b)
    d = torch.cat([d[:1] + 1, d[1:], d.new_zeros((1, d.shape[-1]))])
    m17 = mp.t("m17", a.device)
    first, second, _ = _pick(d, d + m17, 17, PIECE_BITS + 2, 16)
    return torch.where(first[NP : NP + 1] != 0, first[:NP], second[:NP])


# ---------------------------------------------------------------------------
# word-level modular ops
# ---------------------------------------------------------------------------

def _flat(*xs: torch.Tensor):
    """Broadcast word tensors ``(NW, *batch)`` to one shape, flattened to
    ``(NW, N)``; returns the flat tensors and the batch shape."""
    shape = torch.broadcast_shapes(*(x.shape for x in xs))
    return [x.expand(shape).reshape(NW, -1) for x in xs], shape[1:]


def mont_mul(a: torch.Tensor, b: torch.Tensor, mp: ModParams) -> torch.Tensor:
    (a, b), batch = _flat(a, b)
    return from_pieces(mont_mul_p(to_pieces(a), to_pieces(b), mp)).reshape(NW, *batch)


def mod_mul(a: torch.Tensor, b: torch.Tensor, mp: ModParams) -> torch.Tensor:
    """Batched ``(a * b) mod m`` over canonical words (batch dims broadcast)."""
    (a, b), batch = _flat(a, b)
    return from_pieces(mod_mul_p(to_pieces(a), to_pieces(b), mp)).reshape(NW, *batch)


def mod_add(a: torch.Tensor, b: torch.Tensor, mp: ModParams) -> torch.Tensor:
    (a, b), batch = _flat(a, b)
    return from_pieces(mod_add_p(to_pieces(a), to_pieces(b), mp)).reshape(NW, *batch)


def mod_sub(a: torch.Tensor, b: torch.Tensor, mp: ModParams) -> torch.Tensor:
    (a, b), batch = _flat(a, b)
    return from_pieces(mod_sub_p(to_pieces(a), to_pieces(b), mp)).reshape(NW, *batch)


def mod_neg(a: torch.Tensor, mp: ModParams) -> torch.Tensor:
    return mod_sub(torch.zeros_like(a), a, mp)


def sum_mod(a: torch.Tensor, mp: ModParams) -> torch.Tensor:
    """Sum of canonical ``(NW, n)`` elements over the batch axis -> ``(NW,)``.

    ``S < n m < m 2^256``: ``REDC(S) = S R^-1``, then one REDC by ``R^2``.
    Piece sums stay within REDC's limb bound for ``n < 2^22``."""
    n = a.shape[-1]
    if n >= 1 << 22:
        raise ValueError("sum_mod: more than 2^22 - 1 summands")
    s = to_pieces(a).sum(-1, keepdim=True)
    x = _redc(s, mp, PIECE_BITS + max(1, n.bit_length()))
    return from_pieces(mont_mul_p(x, mp.t("r2", a.device), mp))[:, 0]


def inner_product_mod(a: torch.Tensor, b: torch.Tensor, mp: ModParams) -> torch.Tensor:
    """``<a, b> mod m`` for ``(NW, n)`` inputs -> ``(NW,)``.

    Per-lane REDC gives ``a_i b_i R^-1``; their sum is REDC'd once more and
    the ``R^-2`` removed with one REDC by ``R^3``.  ``n < 2^22``."""
    n = a.shape[-1]
    if n >= 1 << 22:
        raise ValueError("inner_product_mod: more than 2^22 - 1 terms")
    x = mont_mul_p(to_pieces(a), to_pieces(b), mp)
    s = _redc(x.sum(-1, keepdim=True), mp, PIECE_BITS + max(1, n.bit_length()))
    return from_pieces(mont_mul_p(s, mp.t("r3", a.device), mp))[:, 0]


def powers(x: torch.Tensor, n: int, mp: ModParams) -> torch.Tensor:
    """``[1, x, ..., x^(n-1)]`` for one ``(NW,)`` element -> ``(NW, n)``.

    Doubling construction: ``P_2k = P_k ++ x^k P_k``."""
    out = from_const(1, (1,), x.device)
    x_pow = x[:, None]
    while out.shape[-1] < n:
        out = torch.cat([out, mod_mul(out, x_pow, mp)], dim=-1)
        x_pow = mod_mul(x_pow, x_pow, mp)
    return out[:, :n]


def from_const(value: int, batch_shape, device) -> torch.Tensor:
    col = torch.as_tensor(ints_to_words([value]), device=device)
    return col.reshape((NW,) + (1,) * len(batch_shape)).expand((NW,) + tuple(batch_shape))


def reduce_512(pieces32: torch.Tensor, mp: ModParams) -> torch.Tensor:
    """Normalized ``(32, ...)`` pieces of a value ``< 2^512`` -> canonical
    words of the value mod m: ``lo mod m + hi 2^256 mod m``."""
    lo, hi = pieces32[:NP], pieces32[NP:]
    r2 = mp.t("r2", pieces32.device)
    lo_m = mont_mul_p(_redc(lo, mp, PIECE_BITS), r2, mp)
    hi_m = mont_mul_p(hi, r2, mp)
    return from_pieces(mod_add_p(lo_m, hi_m, mp))
