"""Symbolic variables and sparse linear combinations — the gadget DSL.

The port's copy of the JAX package's module: a ``Variable`` names a
wire (committed input, multiplier left/right/output, or the constants
one/zero); a ``LinearCombination`` is a sparse map variable -> coefficient
with full operator overloading so gadget code reads algebraically:

    cs.constrain(a + b - c * Scalar(2))
"""

from __future__ import annotations

from ...ops.field import Scalar

# Variable kinds (ordering irrelevant; index ordering matters for weights).
COMMITTED = "V"
MULT_LEFT = "aL"
MULT_RIGHT = "aR"
MULT_OUT = "aO"
ONE = "1"
ZERO = "0"


class Variable:
    """A constraint-system wire (reference linear_combination.rs:14-28)."""

    __slots__ = ("kind", "index")

    def __init__(self, kind: str, index: int = 0):
        self.kind = kind
        self.index = index

    # -- constructors -------------------------------------------------------

    @staticmethod
    def committed(i: int) -> "Variable":
        return Variable(COMMITTED, i)

    @staticmethod
    def multiplier_left(i: int) -> "Variable":
        return Variable(MULT_LEFT, i)

    @staticmethod
    def multiplier_right(i: int) -> "Variable":
        return Variable(MULT_RIGHT, i)

    @staticmethod
    def multiplier_output(i: int) -> "Variable":
        return Variable(MULT_OUT, i)

    @staticmethod
    def one() -> "Variable":
        return Variable(ONE, 0)

    @staticmethod
    def zero() -> "Variable":
        return Variable(ZERO, 0)

    # -- identity -----------------------------------------------------------

    def __eq__(self, other):
        return (
            isinstance(other, Variable)
            and self.kind == other.kind
            and self.index == other.index
        )

    def __hash__(self):
        return hash((self.kind, self.index))

    def __repr__(self):
        if self.kind in (ONE, ZERO):
            return f"Variable({self.kind})"
        return f"Variable({self.kind}[{self.index}])"

    # -- algebra ------------------------------------------------------------

    def to_lc(self) -> "LinearCombination":
        return LinearCombination({self: Scalar(1)})

    def __add__(self, other):
        return self.to_lc() + _as_lc(other)

    def __radd__(self, other):
        return _as_lc(other) + self.to_lc()

    def __sub__(self, other):
        return self.to_lc() - _as_lc(other)

    def __rsub__(self, other):
        return _as_lc(other) - self.to_lc()

    def __mul__(self, other):
        return LinearCombination({self: _as_scalar(other)})

    __rmul__ = __mul__

    def __neg__(self):
        return LinearCombination({self: Scalar(-1)})


class LinearCombination:
    """Sparse LC ``sum coeff_i * var_i`` (reference linear_combination.rs:118)."""

    __slots__ = ("terms",)

    def __init__(self, terms: dict[Variable, Scalar] | None = None):
        self.terms = dict(terms) if terms else {}

    def add_term(self, var: Variable, coeff: Scalar) -> None:
        """Insert-or-accumulate (reference :129-135)."""
        cur = self.terms.get(var)
        self.terms[var] = coeff if cur is None else cur + coeff

    def copy(self) -> "LinearCombination":
        return LinearCombination(self.terms)

    # -- algebra ------------------------------------------------------------

    def __add__(self, other):
        out = self.copy()
        for var, coeff in _as_lc(other).terms.items():
            out.add_term(var, coeff)
        return out

    __radd__ = __add__

    def __sub__(self, other):
        out = self.copy()
        for var, coeff in _as_lc(other).terms.items():
            out.add_term(var, -coeff)
        return out

    def __rsub__(self, other):
        return _as_lc(other) - self

    def __mul__(self, other):
        s = _as_scalar(other)
        return LinearCombination({v: c * s for v, c in self.terms.items()})

    __rmul__ = __mul__

    def __neg__(self):
        return LinearCombination({v: -c for v, c in self.terms.items()})

    def __repr__(self):
        return f"LinearCombination({self.terms!r})"

    # -- weights export ------------------------------------------------------

    def extract_weights(self):
        """Nonzero weights as sparse rows, index-sorted (reference :140-192).

        Returns ``(w_l_row, w_r_row, w_o_row, w_v_row, c)`` where each row is
        a list of ``(index, Scalar)`` and ``c`` is the (optional) constant;
        committed and constant weights are negated, matching the move of
        those terms to the other side of ``lc = 0``.
        """
        w_l, w_r, w_o, w_v = [], [], [], []
        c = None
        items = [(v, coeff) for v, coeff in self.terms.items() if not coeff.is_zero()]
        items.sort(key=lambda t: t[0].index)
        for var, coeff in items:
            if var.kind == MULT_LEFT:
                w_l.append((var.index, coeff))
            elif var.kind == MULT_RIGHT:
                w_r.append((var.index, coeff))
            elif var.kind == MULT_OUT:
                w_o.append((var.index, coeff))
            elif var.kind == COMMITTED:
                w_v.append((var.index, -coeff))
            elif var.kind == ONE:
                c = -coeff
        return w_l, w_r, w_o, w_v, c


def _as_scalar(value) -> Scalar:
    if isinstance(value, Scalar):
        return value
    if isinstance(value, int):
        return Scalar(value)
    raise TypeError(f"expected Scalar/int, got {type(value)!r}")


def _as_lc(value) -> LinearCombination:
    if isinstance(value, LinearCombination):
        return value
    if isinstance(value, Variable):
        return value.to_lc()
    if isinstance(value, (Scalar, int)):
        return LinearCombination({Variable.one(): _as_scalar(value)})
    raise TypeError(f"cannot convert {type(value)!r} to LinearCombination")
