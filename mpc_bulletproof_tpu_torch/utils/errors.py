"""Error classes of the port (the subset of the JAX package's taxonomy that
the range and R1CS provers, their verifiers and the proof codecs raise)."""

from __future__ import annotations


class BulletproofError(Exception):
    """Base class for all errors raised by mpc_bulletproof_tpu_torch."""


class ProofError(BulletproofError):
    """Errors from proof creation or verification."""


class VerificationError(ProofError):
    """The proof failed to verify."""


class FormatError(ProofError):
    """Byte-level proof parsing failed."""


class MPCError(BulletproofError):
    """Errors of the party/dealer protocol (sizes, counts)."""


class R1CSError(BulletproofError):
    """Errors of the constraint-system API."""


class MissingAssignmentError(R1CSError):
    """A prover-side variable was allocated without an assignment."""


class InvalidGeneratorsLengthError(R1CSError):
    """The ``BulletproofGens`` capacity is smaller than the circuit needs."""


class GadgetError(R1CSError):
    """A gadget failed to build its constraints."""
