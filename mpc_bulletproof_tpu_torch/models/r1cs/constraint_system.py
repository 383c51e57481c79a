"""Constraint-system interfaces and the exportable weights IR.

The port's copy of the JAX package's module: the ``ConstraintSystem``
API shared by gadget code between prover and verifier, the two-phase
randomization extension, and the serializable sparse circuit-weights export
(``CircuitWeights``) used to ship the public circuit structure to external
verifiers (e.g. a Cairo verifier).
"""

from __future__ import annotations

import abc
import json

from ...ops.field import Scalar
from .linear_combination import LinearCombination, Variable


class SparseWeightRow:
    """One constraint row: list of ``(index, Scalar)`` (reference :8-9)."""

    __slots__ = ("entries",)

    def __init__(self, entries=None):
        self.entries = list(entries) if entries else []

    def __eq__(self, other):
        return isinstance(other, SparseWeightRow) and self.entries == other.entries

    def __repr__(self):
        return f"SparseWeightRow({self.entries!r})"

    def to_json(self):
        return [[i, hex(int(c))] for i, c in self.entries]

    @staticmethod
    def from_json(data):
        return SparseWeightRow([(i, Scalar(int(c, 16))) for i, c in data])


class SparseReducedMatrix:
    """Rows of sparse weights, one per constraint (reference :25-26)."""

    __slots__ = ("rows",)

    def __init__(self, rows=None):
        self.rows = list(rows) if rows else []

    def __eq__(self, other):
        return isinstance(other, SparseReducedMatrix) and self.rows == other.rows

    def __repr__(self):
        return f"SparseReducedMatrix({self.rows!r})"

    def to_json(self):
        return [r.to_json() for r in self.rows]

    @staticmethod
    def from_json(data):
        return SparseReducedMatrix([SparseWeightRow.from_json(r) for r in data])


class CircuitWeights:
    """The public circuit structure: W_L, W_R, W_O, W_V and constants c
    (reference :34-41).  JSON-serializable for external verifiers."""

    __slots__ = ("w_l", "w_r", "w_o", "w_v", "c")

    def __init__(self, w_l, w_r, w_o, w_v, c):
        self.w_l, self.w_r, self.w_o, self.w_v, self.c = w_l, w_r, w_o, w_v, c

    def __eq__(self, other):
        return (
            isinstance(other, CircuitWeights)
            and self.w_l == other.w_l
            and self.w_r == other.w_r
            and self.w_o == other.w_o
            and self.w_v == other.w_v
            and self.c == other.c
        )

    def to_json(self) -> str:
        return json.dumps(
            {
                "w_l": self.w_l.to_json(),
                "w_r": self.w_r.to_json(),
                "w_o": self.w_o.to_json(),
                "w_v": self.w_v.to_json(),
                "c": self.c.to_json(),
            }
        )

    @staticmethod
    def from_json(data: str) -> "CircuitWeights":
        d = json.loads(data)
        return CircuitWeights(
            SparseReducedMatrix.from_json(d["w_l"]),
            SparseReducedMatrix.from_json(d["w_r"]),
            SparseReducedMatrix.from_json(d["w_o"]),
            SparseReducedMatrix.from_json(d["w_v"]),
            SparseWeightRow.from_json(d["c"]),
        )


def extract_circuit_weights(constraints) -> CircuitWeights:
    """Build the weights IR from a constraint list (reference prover.rs:76-97)."""
    w_l, w_r, w_o, w_v = (SparseReducedMatrix() for _ in range(4))
    c_row = SparseWeightRow()
    for i, lc in enumerate(constraints):
        l_row, r_row, o_row, v_row, c_i = lc.extract_weights()
        w_l.rows.append(SparseWeightRow(l_row))
        w_r.rows.append(SparseWeightRow(r_row))
        w_o.rows.append(SparseWeightRow(o_row))
        w_v.rows.append(SparseWeightRow(v_row))
        if c_i is not None:
            c_row.entries.append((i, c_i))
    return CircuitWeights(w_l, w_r, w_o, w_v, c_row)


class ConstraintSystem(abc.ABC):
    """The gadget-facing API (reference constraint_system.rs:55-150)."""

    @abc.abstractmethod
    def transcript(self):
        """Lease the proof transcript for extra bound data."""

    @abc.abstractmethod
    def multiply(self, left: LinearCombination, right: LinearCombination):
        """Allocate and constrain a multiplication gate; returns (l, r, o)."""

    @abc.abstractmethod
    def num_constraints(self) -> int: ...

    @abc.abstractmethod
    def num_multipliers(self) -> int: ...

    @abc.abstractmethod
    def get_weights(self) -> CircuitWeights: ...

    @abc.abstractmethod
    def allocate(self, assignment: Scalar | None) -> Variable:
        """Allocate a single low-level variable (pending-multiplier pairing)."""

    @abc.abstractmethod
    def allocate_multiplier(self, input_assignments):
        """Allocate an (l, r, o) triple with l*r = o."""

    @abc.abstractmethod
    def commit_public(self, value: Scalar) -> Variable:
        """Commit a public statement variable (blinding fixed to one)."""

    @abc.abstractmethod
    def constrain(self, lc: LinearCombination) -> None:
        """Enforce ``lc = 0``."""

    @abc.abstractmethod
    def eval(self, lc: LinearCombination) -> Scalar:
        """Evaluate an LC against the witness (verifier returns 0)."""


class RandomizableConstraintSystem(ConstraintSystem):
    """Adds deferred randomized-constraint callbacks (reference :157-183)."""

    @abc.abstractmethod
    def specify_randomized_constraints(self, callback) -> None:
        """Defer ``callback(randomized_cs)`` to the second proving phase."""


class RandomizedConstraintSystem(ConstraintSystem):
    """Second-phase view: can squeeze challenges (reference :190-208)."""

    @abc.abstractmethod
    def challenge_scalar(self, label: bytes) -> Scalar: ...
