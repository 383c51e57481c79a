"""STARK-curve constants (the port's own copy).

The curve is the StarkNet ECDSA curve ``y^2 = x^3 + ALPHA x + BETA`` over
GF(P), with ``P = 2^251 + 17 * 2^192 + 1`` and prime group order ``R`` (the
scalar field).  Byte sizes mirror ``SCALAR_BYTES`` / ``STARK_POINT_BYTES``.
"""

# Base field prime: 2^251 + 17 * 2^192 + 1
P = 0x800000000000011000000000000000000000000000000000000000000000001

# Curve coefficients: y^2 = x^3 + ALPHA x + BETA
ALPHA = 1
BETA = 0x6F21413EFBE40DE150E596D72F7A8C5609AD26C15C915C1F4CDFCB99CEE9E89

# Prime order of the curve group (the scalar field modulus).
R = 0x800000000000010FFFFFFFFFFFFFFFFB781126DCAE7B2321E66A241ADC64D2F

# Standard generator of the curve group.
GEN_X = 0x1EF15C18599971B7BECED415A40F0C7DEACFD9B0D1819E03D723D8BC943CFCA
GEN_Y = 0x5668060AA49730B7BE4801DF46EC62DE53ECD11ABE43A32873000C36E8DC1F

SCALAR_BYTES = 32
STARK_POINT_BYTES = 32
KECCAK_OUTPUT_SIZE = 32

# Number of bits needed to represent a base-field / scalar-field element.
FIELD_BITS = 252
