"""Host STARK-curve group arithmetic (``StarkPoint``), pure Python.

The port's own copy of the JAX package's host point type: identity and
generator, add/double/negate, scalar multiplication, a small host MSM,
compressed 32-byte serialization, and the transcript encoding helper.
Exact Python integers; the golden model of the tensor point layer
(:mod:`.curve_t`).  Bulk point work runs on the card (:mod:`.msm`).

Compressed point format (32 bytes, little-endian ``x`` with flag bits in the
top byte — ark-serialize style, matching the 32-byte ``STARK_POINT_BYTES``
constant of the reference):

* byte[31] bit6 (0x40): point at infinity (all other bytes zero)
* byte[31] bit7 (0x80): ``y`` is "negative" (i.e. ``y > P - y``)
"""

from __future__ import annotations

from typing import Sequence

from ..constants import ALPHA, BETA, GEN_X, GEN_Y, P, R, STARK_POINT_BYTES
from .field import Scalar

_INF_FLAG = 0x40
_NEG_FLAG = 0x80


# Square roots mod P.  P - 1 = _TS_Q * 2^_TS_S with _TS_Q = 2^59 + 17 odd
# and _TS_S = 192: the 2-adicity is so large that classic Tonelli-Shanks
# costs O(S^2) ~ 37k modmuls (~4 ms) per decompression — the single most
# expensive scalar operation in the library.  Instead we solve the square
# root via a windowed Pohlig-Hellman discrete log in the 2-Sylow subgroup:
#
#   t = a^q lies in <g>, g = z^q of order 2^S.  Find e with t = g^e one
#   w-bit digit at a time (a table lookup in the order-2^w subgroup per
#   digit, corrections from a precomputed g^(-d*2^m) table), then
#   r = a^((q+1)/2) * g^(-e/2).  a is a QR iff e is even.
#
# Cost: ~S squarings + ~D^2/2 table muls + one 59-bit pow ~ 600 modmuls
# (~50x faster).  Tables (built lazily, ~49k modmuls once): 192 rows of
# g^(-d*2^m) for d < 2^w, plus the dlog dictionary of the order-2^w
# subgroup.
_TS_Q = P - 1
_TS_S = 0
while _TS_Q % 2 == 0:
    _TS_Q //= 2
    _TS_S += 1
_z = 2
while pow(_z, (P - 1) // 2, P) != P - 1:
    _z += 1
_TS_CZ = pow(_z, _TS_Q, P)
del _z

_SQRT_W = 8
_SQRT_D = -(-_TS_S // _SQRT_W)
_SQRT_TABLES: tuple[list[list[int]], dict[int, int]] | None = None


def _build_sqrt_tables():
    g_inv = pow(_TS_CZ, -1, P)
    rows = []
    base = g_inv  # g^(-2^m)
    width = 1 << _SQRT_W
    for _m in range(_TS_S):
        row = [1] * width
        for d in range(1, width):
            row[d] = row[d - 1] * base % P
        rows.append(row)
        base = base * base % P
    h = pow(_TS_CZ, 1 << (_TS_S - _SQRT_W), P)  # order-2^w generator
    dlog = {}
    cur = 1
    for k in range(width):
        dlog[cur] = k
        cur = cur * h % P
    return rows, dlog


def _sqrt_mod_p(a: int) -> int | None:
    global _SQRT_TABLES
    if a == 0:
        return 0
    if _SQRT_TABLES is None:
        _SQRT_TABLES = _build_sqrt_tables()
    rows, dlog = _SQRT_TABLES
    s, w = _TS_S, _SQRT_W

    t = pow(a, _TS_Q, P)
    ladder = [t]  # t^(2^i)
    for _ in range(s - w):
        ladder.append(ladder[-1] * ladder[-1] % P)

    e = 0
    digits: list[int] = []
    for j in range(_SQRT_D):
        proj = s - w * (j + 1)
        u = ladder[proj]
        for i, di in enumerate(digits):
            if di:
                u = u * rows[w * i + proj][di] % P
        dig = dlog.get(u)
        if dig is None:  # t not in <g>: cannot happen for field elements
            return None
        digits.append(dig)
        e |= dig << (w * j)
    if e & 1:
        return None  # quadratic non-residue

    r = pow(a, (_TS_Q + 1) // 2, P)
    half = e >> 1
    for j in range(_SQRT_D):
        d = (half >> (w * j)) & ((1 << w) - 1)
        if d:
            r = r * rows[w * j][d] % P
    return r


class StarkPoint:
    """A point on the STARK curve ``y^2 = x^3 + ALPHA x + BETA`` over GF(P).

    Stored affine; ``x is None`` encodes the identity (point at infinity).
    """

    __slots__ = ("x", "y")

    def __init__(self, x: int | None = None, y: int | None = None):
        self.x = x
        self.y = y

    # -- constructors -------------------------------------------------------

    @staticmethod
    def identity() -> "StarkPoint":
        return StarkPoint(None, None)

    @staticmethod
    def generator() -> "StarkPoint":
        return StarkPoint(GEN_X, GEN_Y)

    @staticmethod
    def from_affine(x: int, y: int) -> "StarkPoint":
        pt = StarkPoint(x % P, y % P)
        if not pt.is_on_curve():
            raise ValueError("point is not on the STARK curve")
        return pt

    # -- predicates ---------------------------------------------------------

    def is_identity(self) -> bool:
        return self.x is None

    def is_on_curve(self) -> bool:
        if self.is_identity():
            return True
        return (self.y * self.y - (self.x * self.x * self.x + ALPHA * self.x + BETA)) % P == 0

    def to_affine(self) -> "StarkPoint":
        return self

    # -- group law ----------------------------------------------------------

    def __add__(self, other: "StarkPoint") -> "StarkPoint":
        if not isinstance(other, StarkPoint):
            return NotImplemented
        if self.is_identity():
            return other
        if other.is_identity():
            return self
        x1, y1, x2, y2 = self.x, self.y, other.x, other.y
        if x1 == x2:
            if (y1 + y2) % P == 0:
                return StarkPoint.identity()
            return self.double()
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
        x3 = (lam * lam - x1 - x2) % P
        y3 = (lam * (x1 - x3) - y1) % P
        return StarkPoint(x3, y3)

    def double(self) -> "StarkPoint":
        if self.is_identity():
            return self
        if self.y == 0:
            return StarkPoint.identity()
        lam = (3 * self.x * self.x + ALPHA) * pow(2 * self.y, -1, P) % P
        x3 = (lam * lam - 2 * self.x) % P
        y3 = (lam * (self.x - x3) - self.y) % P
        return StarkPoint(x3, y3)

    def __neg__(self) -> "StarkPoint":
        if self.is_identity():
            return self
        return StarkPoint(self.x, (-self.y) % P)

    def __sub__(self, other: "StarkPoint") -> "StarkPoint":
        return self + (-other)

    def scalar_mul(self, scalar: Scalar | int) -> "StarkPoint":
        """Windowed (4-bit) scalar multiplication, Jacobian internally."""
        k = int(scalar) % R
        if k == 0 or self.is_identity():
            return StarkPoint.identity()
        # fixed 4-bit window table
        table = [_JacPoint.identity()] * 16
        base = _JacPoint.from_affine(self)
        table[1] = base
        for i in range(2, 16):
            table[i] = table[i - 1].add(base)
        acc = _JacPoint.identity()
        nibbles = []
        while k > 0:
            nibbles.append(k & 0xF)
            k >>= 4
        for nib in reversed(nibbles):
            for _ in range(4):
                acc = acc.double()
            if nib:
                acc = acc.add(table[nib])
        return acc.to_affine()

    def __mul__(self, scalar):
        if isinstance(scalar, (Scalar, int)):
            return self.scalar_mul(scalar)
        return NotImplemented

    __rmul__ = __mul__

    # -- MSM ----------------------------------------------------------------

    @staticmethod
    def msm(scalars: Sequence[Scalar], points: Sequence["StarkPoint"]) -> "StarkPoint":
        """Variable-base multi-scalar multiplication (host Pippenger)."""
        if len(scalars) != len(points):
            raise ValueError("msm: scalar/point length mismatch")
        n = len(scalars)
        if n == 0:
            return StarkPoint.identity()
        if n <= 4:
            acc = StarkPoint.identity()
            for s, pt in zip(scalars, points):
                acc = acc + pt.scalar_mul(s)
            return acc
        # Pippenger
        c = 4 if n < 32 else (8 if n < 1024 else 12)
        num_windows = (252 + c - 1) // c
        ks = [int(s) % R for s in scalars]
        jpts = [_JacPoint.from_affine(pt) for pt in points]
        window_sums: list[_JacPoint] = []
        for w in range(num_windows):
            shift = w * c
            buckets: dict[int, _JacPoint] = {}
            for k, jp in zip(ks, jpts):
                digit = (k >> shift) & ((1 << c) - 1)
                if digit:
                    cur = buckets.get(digit)
                    buckets[digit] = jp if cur is None else cur.add(jp)
            # running-sum bucket reduction
            acc = _JacPoint.identity()
            total = _JacPoint.identity()
            for digit in range(max(buckets) if buckets else 0, 0, -1):
                b = buckets.get(digit)
                if b is not None:
                    acc = acc.add(b)
                total = total.add(acc)
            window_sums.append(total)
        # Horner over windows
        result = _JacPoint.identity()
        for wsum in reversed(window_sums):
            for _ in range(c):
                result = result.double()
            result = result.add(wsum)
        return result.to_affine()

    @staticmethod
    def random(rng=None) -> "StarkPoint":
        """A random curve point (random scalar times the generator)."""
        return StarkPoint.generator().scalar_mul(Scalar.random(rng))

    # -- codecs -------------------------------------------------------------

    def to_bytes(self) -> bytes:
        """Compressed 32-byte encoding (see module docstring)."""
        if self.is_identity():
            buf = bytearray(STARK_POINT_BYTES)
            buf[31] |= _INF_FLAG
            return bytes(buf)
        buf = bytearray(self.x.to_bytes(STARK_POINT_BYTES, "little"))
        if self.y > P - self.y:
            buf[31] |= _NEG_FLAG
        return bytes(buf)

    @staticmethod
    def from_bytes(data: bytes) -> "StarkPoint":
        if len(data) != STARK_POINT_BYTES:
            raise ValueError("point encoding must be 32 bytes")
        flags = data[31] & 0xC0
        if flags == (_INF_FLAG | _NEG_FLAG):
            # ark-serialize rejects conflicting flags; accepting both would
            # give the identity two distinct encodings (codec malleability).
            raise ValueError("conflicting point flags")
        if flags & _INF_FLAG:
            if any(data[:31]) or data[31] & 0x3F:
                raise ValueError("invalid identity encoding")
            return StarkPoint.identity()
        x = int.from_bytes(data[:31] + bytes([data[31] & 0x3F]), "little")
        if x >= P:
            raise ValueError("x coordinate out of range")
        rhs = (x * x * x + ALPHA * x + BETA) % P
        y = _sqrt_mod_p(rhs)
        if y is None:
            raise ValueError("x is not on the curve")
        neg = flags & _NEG_FLAG
        if (y > P - y) != bool(neg):
            y = P - y
        return StarkPoint(x, y)

    def __eq__(self, other) -> bool:
        if not isinstance(other, StarkPoint):
            return NotImplemented
        return self.x == other.x and self.y == other.y

    def __hash__(self) -> int:
        return hash(("StarkPoint", self.x, self.y))

    def __repr__(self) -> str:
        if self.is_identity():
            return "StarkPoint(identity)"
        return f"StarkPoint(x=0x{self.x:x}, y=0x{self.y:x})"


class _JacPoint:
    """Jacobian-coordinate point for fast host arithmetic (X/Z^2, Y/Z^3)."""

    __slots__ = ("X", "Y", "Z")

    def __init__(self, X: int, Y: int, Z: int):
        self.X, self.Y, self.Z = X, Y, Z

    @staticmethod
    def identity() -> "_JacPoint":
        return _JacPoint(1, 1, 0)

    @staticmethod
    def from_affine(pt: StarkPoint) -> "_JacPoint":
        if pt.is_identity():
            return _JacPoint.identity()
        return _JacPoint(pt.x, pt.y, 1)

    def is_identity(self) -> bool:
        return self.Z == 0

    def to_affine(self) -> StarkPoint:
        if self.Z == 0:
            return StarkPoint.identity()
        zinv = pow(self.Z, -1, P)
        zinv2 = zinv * zinv % P
        return StarkPoint(self.X * zinv2 % P, self.Y * zinv2 * zinv % P)

    def double(self) -> "_JacPoint":
        if self.Z == 0 or self.Y == 0:
            return _JacPoint.identity() if self.Y == 0 else self
        X1, Y1, Z1 = self.X, self.Y, self.Z
        # dbl-2007-bl (general a)
        XX = X1 * X1 % P
        YY = Y1 * Y1 % P
        YYYY = YY * YY % P
        ZZ = Z1 * Z1 % P
        S = 2 * ((X1 + YY) ** 2 - XX - YYYY) % P
        M = (3 * XX + ALPHA * ZZ % P * ZZ) % P
        T = (M * M - 2 * S) % P
        Y3 = (M * (S - T) - 8 * YYYY) % P
        Z3 = ((Y1 + Z1) ** 2 - YY - ZZ) % P
        return _JacPoint(T, Y3, Z3)

    def add(self, other: "_JacPoint") -> "_JacPoint":
        if self.Z == 0:
            return other
        if other.Z == 0:
            return self
        X1, Y1, Z1 = self.X, self.Y, self.Z
        X2, Y2, Z2 = other.X, other.Y, other.Z
        Z1Z1 = Z1 * Z1 % P
        Z2Z2 = Z2 * Z2 % P
        U1 = X1 * Z2Z2 % P
        U2 = X2 * Z1Z1 % P
        S1 = Y1 * Z2 % P * Z2Z2 % P
        S2 = Y2 * Z1 % P * Z1Z1 % P
        if U1 == U2:
            if S1 != S2:
                return _JacPoint.identity()
            return self.double()
        H = (U2 - U1) % P
        I = 4 * H * H % P
        J = H * I % P
        rr = 2 * (S2 - S1) % P
        V = U1 * I % P
        X3 = (rr * rr - J - 2 * V) % P
        Y3 = (rr * (V - X3) - 2 * S1 * J) % P
        Z3 = ((Z1 + Z2) ** 2 - Z1Z1 - Z2Z2) * H % P
        return _JacPoint(X3, Y3, Z3)


def stark_point_to_transcript_bytes(point: StarkPoint) -> bytes:
    """Cairo-style transcript encoding: affine ``x || y`` as 32-byte LE felts;
    identity encodes as 64 zero bytes."""
    if point.is_identity():
        return b"\x00" * 64
    return point.x.to_bytes(32, "little") + point.y.to_bytes(32, "little")


def random_point(rng=None) -> StarkPoint:
    """A random curve point: :meth:`StarkPoint.random`."""
    return StarkPoint.random(rng)
