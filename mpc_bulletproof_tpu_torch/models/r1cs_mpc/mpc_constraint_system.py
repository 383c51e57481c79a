"""Constraint-system interfaces of the collaborative prover: the single
prover's over shared values.  ``eval`` gives an authenticated shared
scalar, ``multiply`` consumes Beaver triples, and randomized constraints
squeeze public challenges from the parties' common transcript."""

from __future__ import annotations

import abc


class MpcConstraintSystem(abc.ABC):
    @abc.abstractmethod
    def transcript(self): ...

    @abc.abstractmethod
    def multiply(self, left, right):
        """Allocate and constrain ``l r = o`` over shared values (one Beaver
        multiplication)."""

    @abc.abstractmethod
    def num_constraints(self) -> int: ...

    @abc.abstractmethod
    def num_multipliers(self) -> int: ...

    @abc.abstractmethod
    def allocate(self, assignment): ...

    @abc.abstractmethod
    def allocate_multiplier(self, input_assignments): ...

    @abc.abstractmethod
    def constrain(self, lc) -> None: ...

    @abc.abstractmethod
    def eval(self, lc):
        """Evaluate a linear combination to an authenticated shared scalar."""


class MpcRandomizableConstraintSystem(MpcConstraintSystem):
    @abc.abstractmethod
    def specify_randomized_constraints(self, callback) -> None: ...


class MpcRandomizedConstraintSystem(MpcConstraintSystem):
    @abc.abstractmethod
    def challenge_scalar(self, label: bytes):
        """A public Fiat-Shamir challenge (both parties derive the same)."""
