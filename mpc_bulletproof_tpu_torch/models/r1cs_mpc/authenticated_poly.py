"""Vector polynomials over authenticated shares.

``special_inner_product`` is the collaborative prover's heaviest Beaver
step: its nine elementwise products go into one Beaver round, so the
whole t-polynomial costs one round trip.  From :data:`DEVICE_MIN_WIDTH`
lanes on it and :meth:`AuthenticatedVecPoly3.eval` run on the device
share plane (:class:`...parallel.device_shares.DeviceShareVector`) on the
fabric's device, the JAX package's routing by size: on a CUDA device
the t-polynomial's Beaver round is three launches of ``csrc/vec2.cu`` and
an evaluation one, on the CPU their plain versions.  Below it they run
on the host shares.
"""

from __future__ import annotations

from ...ops.field import Scalar
from ...parallel.fabric import AuthenticatedScalarVector

# Width from which the device share plane serves (the JAX package's).
DEVICE_MIN_WIDTH = 16


class AuthenticatedVecPoly3:
    """``l(x) = c0 + c1 x + c2 x^2 + c3 x^3`` with shared coefficients."""

    def __init__(self, c0, c1, c2, c3):
        self.c0, self.c1, self.c2, self.c3 = c0, c1, c2, c3

    @staticmethod
    def zero(n: int, fabric) -> "AuthenticatedVecPoly3":
        return AuthenticatedVecPoly3(*(fabric.zeros_authenticated(n) for _ in range(4)))

    @staticmethod
    def special_inner_product(lhs, rhs) -> "AuthenticatedPoly6":
        """The t(x) coefficients for ``lhs.c0 = 0`` and ``rhs.c2 = 0``, in one
        Beaver round."""
        n = len(lhs.c1)
        pairs = [
            (lhs.c1, rhs.c0),  # t1
            (lhs.c1, rhs.c1),  # t2 (1/2)
            (lhs.c2, rhs.c0),  # t2 (2/2)
            (lhs.c2, rhs.c1),  # t3 (1/2)
            (lhs.c3, rhs.c0),  # t3 (2/2)
            (lhs.c1, rhs.c3),  # t4 (1/2)
            (lhs.c3, rhs.c1),  # t4 (2/2)
            (lhs.c2, rhs.c3),  # t5
            (lhs.c3, rhs.c3),  # t6
        ]
        x_cat = AuthenticatedScalarVector.concat([p[0] for p in pairs])
        y_cat = AuthenticatedScalarVector.concat([p[1] for p in pairs])

        if n >= DEVICE_MIN_WIDTH:
            # the 9n products on the device; only the six coefficients
            # (a scalar and its MAC each) come back to the host
            from ...parallel.device_shares import DeviceShareVector

            prods = DeviceShareVector.from_host(x_cat).beaver_mul(DeviceShareVector.from_host(y_cat))
            block_sum = lambda i: prods[i * n : (i + 1) * n].sum().to_host()
        else:
            prods = x_cat.fabric.beaver_mul(x_cat, y_cat)
            block_sum = lambda i: prods[i * n : (i + 1) * n].sum()

        return AuthenticatedPoly6(
            block_sum(0),
            block_sum(1) + block_sum(2),
            block_sum(3) + block_sum(4),
            block_sum(5) + block_sum(6),
            block_sum(7),
            block_sum(8),
        )

    def eval(self, x: Scalar) -> AuthenticatedScalarVector:
        """Horner evaluation at a public ``x`` (local to each party)."""
        if len(self.c1) >= DEVICE_MIN_WIDTH:
            from ...parallel.device_shares import DeviceShareVector

            return DeviceShareVector.poly3([self.c0, self.c1, self.c2, self.c3], x).to_host()
        out = self.c3.mul_public(x) + self.c2
        out = out.mul_public(x) + self.c1
        return out.mul_public(x) + self.c0


class AuthenticatedPoly6:
    """``t1 x + ... + t6 x^6`` with shared coefficients (no constant term)."""

    def __init__(self, t1, t2, t3, t4, t5, t6):
        self.t1, self.t2, self.t3, self.t4, self.t5, self.t6 = t1, t2, t3, t4, t5, t6

    def eval(self, x: Scalar) -> AuthenticatedScalarVector:
        out = self.t6.mul_public(x) + self.t5
        out = out.mul_public(x) + self.t4
        out = out.mul_public(x) + self.t3
        out = out.mul_public(x) + self.t2
        out = out.mul_public(x) + self.t1
        return out.mul_public(x)
