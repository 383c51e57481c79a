"""Host scalar-field arithmetic (``Scalar``), pure Python.

The port's own copy of the JAX package's host ``Scalar``: exact Python
integers mod ``R``, used for the protocol glue (blinding draws, proof
scalars) and as the golden model of the tensor field layer
(:mod:`.limb`).
"""

from __future__ import annotations

import secrets
from typing import Sequence

from ..constants import R, SCALAR_BYTES


class Scalar:
    """An element of the STARK-curve scalar field (integers mod ``R``)."""

    __slots__ = ("value",)

    MODULUS = R

    def __init__(self, value: "int | Scalar" = 0):
        if isinstance(value, Scalar):
            self.value = value.value
        else:
            self.value = value % R

    @staticmethod
    def zero() -> "Scalar":
        return Scalar(0)

    @staticmethod
    def one() -> "Scalar":
        return Scalar(1)

    @staticmethod
    def random(rng=None) -> "Scalar":
        """Uniformly random scalar. ``rng`` may supply ``randbytes(n)``."""
        raw = (
            secrets.token_bytes(SCALAR_BYTES + 16)
            if rng is None
            else rng.randbytes(SCALAR_BYTES + 16)
        )
        return Scalar(int.from_bytes(raw, "big"))

    @staticmethod
    def from_be_bytes_mod_order(data: bytes) -> "Scalar":
        return Scalar(int.from_bytes(data, "big"))

    def to_bytes_be(self) -> bytes:
        return self.value.to_bytes(SCALAR_BYTES, "big")

    def __add__(self, other):
        if not isinstance(other, (Scalar, int)):
            return NotImplemented
        return Scalar(self.value + int(other))

    __radd__ = __add__

    def __sub__(self, other):
        if not isinstance(other, (Scalar, int)):
            return NotImplemented
        return Scalar(self.value - int(other))

    def __rsub__(self, other):
        if not isinstance(other, (Scalar, int)):
            return NotImplemented
        return Scalar(int(other) - self.value)

    def __mul__(self, other):
        if not isinstance(other, (Scalar, int)):
            return NotImplemented
        return Scalar(self.value * int(other))

    __rmul__ = __mul__

    def is_zero(self) -> bool:
        return self.value == 0

    def __neg__(self) -> "Scalar":
        return Scalar(-self.value)

    def __pow__(self, exponent: int) -> "Scalar":
        return Scalar(pow(self.value, exponent, R))

    def inverse(self) -> "Scalar":
        """Multiplicative inverse (raises ``ValueError`` on zero)."""
        return Scalar(pow(self.value, -1, R))

    def __eq__(self, other) -> bool:
        if isinstance(other, Scalar):
            return self.value == other.value
        if isinstance(other, int):
            return self.value == other % R
        return NotImplemented

    def __hash__(self) -> int:
        return hash(("Scalar", self.value))

    def __repr__(self) -> str:
        return f"Scalar(0x{self.value:x})"

    def __int__(self) -> int:
        return self.value

    # -- batch helpers ------------------------------------------------------

    @staticmethod
    def batch_inverse(values: Sequence["Scalar"]) -> list["Scalar"]:
        """Montgomery's trick: the inverses of ``values`` with one field
        inversion.  A zero input raises ``ValueError``."""
        n = len(values)
        if n == 0:
            return []
        prefix = [0] * n
        acc = 1
        for i, v in enumerate(values):
            acc = acc * v.value % R
            prefix[i] = acc
        inv = pow(acc, -1, R)
        out: list[Scalar] = [Scalar(0)] * n
        for i in range(n - 1, 0, -1):
            out[i] = Scalar(prefix[i - 1] * inv)
            inv = inv * values[i].value % R
        out[0] = Scalar(inv)
        return out


def inner_product(a: Sequence[Scalar], b: Sequence[Scalar]) -> Scalar:
    """``<a, b>`` over the scalar field."""
    if len(a) != len(b):
        raise ValueError("inner_product(a,b): lengths of vectors do not match")
    return Scalar(sum(x.value * y.value for x, y in zip(a, b)))


def exp_iter(x: Scalar):
    """Endless iterator ``1, x, x^2, ...``."""
    cur = 1
    xv = x.value
    while True:
        yield Scalar(cur)
        cur = cur * xv % R


def scalar_exp_vartime(x: Scalar, n: int) -> Scalar:
    """``x^n`` by binary exponentiation."""
    return Scalar(pow(x.value, n, R))


def scalars_from_ints(values) -> list[Scalar]:
    """``[Scalar(v) for v in values]``."""
    return [Scalar(v) for v in values]


def add_vec(a: Sequence[Scalar], b: Sequence[Scalar]) -> list[Scalar]:
    """Elementwise sum."""
    return [x + y for x, y in zip(a, b)]


def scalar_powers(x: Scalar, n: int) -> list[Scalar]:
    """``[1, x, ..., x^(n-1)]``."""
    out, cur = [], 1
    for _ in range(n):
        out.append(Scalar(cur))
        cur = cur * x.value % R
    return out


def sum_of_powers(x: Scalar, n: int) -> Scalar:
    """``1 + x + ... + x^(n-1)``; by the doubling recurrence when ``n`` is a
    power of two."""
    if n == 0:
        return Scalar(0)
    if n & (n - 1):
        acc, cur = 0, 1
        for _ in range(n):
            acc += cur
            cur = cur * x.value % R
        return Scalar(acc)
    if n == 1:
        return Scalar(1)
    result = (1 + x.value) % R
    factor = x.value
    while n > 2:
        factor = factor * factor % R
        result = (result + factor * result) % R
        n //= 2
    return Scalar(result)
