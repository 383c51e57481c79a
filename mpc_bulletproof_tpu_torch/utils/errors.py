"""Error classes of the port: the JAX package's taxonomy and hierarchy."""

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
    """Errors of the MPC substrate and the party/dealer protocol."""


class AuthenticationError(MPCError):
    """A MAC check failed when opening an authenticated value."""


class NetworkError(MPCError):
    """The two-party transport failed."""


class SetupFailedError(MPCError):
    """Fabric or network setup failed."""


class MultiproverError(BulletproofError):
    """Errors of the collaborative prover."""

    def __init__(self, message: str = "", cause: Exception | None = None):
        super().__init__(message or (str(cause) if cause else ""))
        self.cause = cause


class R1CSError(BulletproofError):
    """Errors of the constraint-system API."""


class MissingAssignmentError(R1CSError):
    """A prover-side variable was allocated without an assignment."""


class InvalidGeneratorsLengthError(R1CSError):
    """The ``BulletproofGens`` capacity is smaller than the circuit needs."""


class GadgetError(R1CSError):
    """A gadget failed to build its constraints."""
