"""Reference gadget library for the R1CS constraint system.

The port's copy of the JAX package's gadgets, which mirror those of the
reference's integration tests (tests/r1cs.rs): the k-shuffle (Neff-style product argument under a
randomized challenge, exercising the two-phase machinery), the example
gadget, and the bit-decomposition range gadget.  They double as the
framework's user-facing gadget examples.
"""

from __future__ import annotations

from ...ops.field import Scalar
from ...utils.errors import GadgetError
from .constraint_system import ConstraintSystem, RandomizableConstraintSystem
from .linear_combination import LinearCombination, Variable


def shuffle_gadget(
    cs: RandomizableConstraintSystem, x: list[Variable], y: list[Variable]
) -> None:
    """Proves ``y`` is a permutation of ``x``: both grand products of
    ``(x_i - z)`` and ``(y_i - z)`` agree for a random challenge ``z``
    (reference tests/r1cs.rs:23-63)."""
    if len(x) != len(y):
        raise GadgetError("shuffle inputs must have equal length")
    k = len(x)
    if k == 1:
        cs.constrain(y[0] - x[0])
        return

    def randomized(rcs):
        z = rcs.challenge_scalar(b"shuffle challenge")
        _, _, last_x = rcs.multiply(x[k - 1] - z, x[k - 2] - z)
        first_x = last_x
        for i in range(k - 3, -1, -1):
            _, _, first_x = rcs.multiply(first_x.to_lc(), x[i] - z)
        _, _, last_y = rcs.multiply(y[k - 1] - z, y[k - 2] - z)
        first_y = last_y
        for i in range(k - 3, -1, -1):
            _, _, first_y = rcs.multiply(first_y.to_lc(), y[i] - z)
        rcs.constrain(first_x - first_y)

    cs.specify_randomized_constraints(randomized)


def example_gadget(
    cs: ConstraintSystem,
    a1: LinearCombination,
    a2: LinearCombination,
    b1: LinearCombination,
    b2: LinearCombination,
    c1: LinearCombination,
    c2: LinearCombination,
) -> None:
    """Constrains (a1 + a2) * (b1 + b2) = (c1 + c2) (tests/r1cs.rs:216-228)."""
    _, _, c_var = cs.multiply(a1 + a2, b1 + b2)
    cs.constrain(c1 + c2 - c_var)


def range_check_gadget(
    cs: ConstraintSystem,
    v: LinearCombination,
    v_assignment: int | None,
    n: int,
) -> None:
    """Enforces ``v`` in [0, 2^n) by bit decomposition (tests/r1cs.rs:620-652):
    per bit, allocate (a, b, o) with a*b = o, constrain o = 0 and a + b = 1
    (so a, b are complementary bits), and subtract b * 2^i from v; finally
    constrain the depleted v to zero."""
    lc = v if isinstance(v, LinearCombination) else v.to_lc()
    lc = lc.copy()
    exp_2 = Scalar(1)
    for i in range(n):
        if v_assignment is not None:
            bit = (int(v_assignment) >> i) & 1
            assignment = (Scalar(1 - bit), Scalar(bit))
        else:
            assignment = None
        a, b, o = cs.allocate_multiplier(assignment)
        cs.constrain(o.to_lc())
        cs.constrain(a + (b - 1))
        lc = lc - b * exp_2
        exp_2 = exp_2 + exp_2
    cs.constrain(lc)
