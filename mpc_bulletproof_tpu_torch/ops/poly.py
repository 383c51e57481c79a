"""Vector and scalar polynomials over the scalar field, on the host.

The port's copy of the JAX package's ``ops/poly.py``: ``VecPoly1`` and
``Poly2`` (degree 1 and 2), ``VecPoly3`` and ``Poly6`` for the
constraint-system prover, whose ``special_inner_product`` uses ``l.0 == 0``
and ``r.2 == 0`` to form t(x) from 8 inner products.
"""

from __future__ import annotations

from .field import Scalar, add_vec, inner_product


class VecPoly1:
    """Degree-1 vector polynomial ``a + b x`` (util.rs:23, :104-135)."""

    def __init__(self, c0: list[Scalar], c1: list[Scalar]):
        self.c0 = c0
        self.c1 = c1

    @staticmethod
    def zero(n: int) -> "VecPoly1":
        return VecPoly1([Scalar(0)] * n, [Scalar(0)] * n)

    def inner_product(self, rhs: "VecPoly1") -> "Poly2":
        """Karatsuba: 3 inner products instead of 4 (util.rs:109-123)."""
        t0 = inner_product(self.c0, rhs.c0)
        t2 = inner_product(self.c1, rhs.c1)
        l_sum = add_vec(self.c0, self.c1)
        r_sum = add_vec(rhs.c0, rhs.c1)
        t1 = inner_product(l_sum, r_sum) - t0 - t2
        return Poly2(t0, t1, t2)

    def eval(self, x: Scalar) -> list[Scalar]:
        return [a + b * x for a, b in zip(self.c0, self.c1)]


class VecPoly3:
    """Degree-3 vector polynomial (util.rs:28-33, :137-182)."""

    def __init__(self, c0, c1, c2, c3):
        self.c0, self.c1, self.c2, self.c3 = c0, c1, c2, c3

    @staticmethod
    def zero(n: int) -> "VecPoly3":
        z = lambda: [Scalar(0)] * n
        return VecPoly3(z(), z(), z(), z())

    @staticmethod
    def special_inner_product(lhs: "VecPoly3", rhs: "VecPoly3") -> "Poly6":
        """t(x) coefficients assuming lhs.c0 == 0 and rhs.c2 == 0."""
        t1 = inner_product(lhs.c1, rhs.c0)
        t2 = inner_product(lhs.c1, rhs.c1) + inner_product(lhs.c2, rhs.c0)
        t3 = inner_product(lhs.c2, rhs.c1) + inner_product(lhs.c3, rhs.c0)
        t4 = inner_product(lhs.c1, rhs.c3) + inner_product(lhs.c3, rhs.c1)
        t5 = inner_product(lhs.c2, rhs.c3)
        t6 = inner_product(lhs.c3, rhs.c3)
        return Poly6(t1, t2, t3, t4, t5, t6)

    def eval(self, x: Scalar) -> list[Scalar]:
        return [
            c0 + x * (c1 + x * (c2 + x * c3))
            for c0, c1, c2, c3 in zip(self.c0, self.c1, self.c2, self.c3)
        ]


class Poly2:
    """a + b x + c x^2 (util.rs:36, :184-188)."""

    def __init__(self, t0: Scalar, t1: Scalar, t2: Scalar):
        self.t0, self.t1, self.t2 = t0, t1, t2

    def eval(self, x: Scalar) -> Scalar:
        return self.t0 + x * (self.t1 + x * self.t2)


class Poly6:
    """t1 x + ... + t6 x^6, no constant term (util.rs:41-48, :190-195)."""

    def __init__(self, t1, t2, t3, t4, t5, t6):
        self.t1, self.t2, self.t3, self.t4, self.t5, self.t6 = t1, t2, t3, t4, t5, t6

    def eval(self, x: Scalar) -> Scalar:
        return x * (
            self.t1
            + x * (self.t2 + x * (self.t3 + x * (self.t4 + x * (self.t5 + x * self.t6))))
        )
