"""Variables and linear combinations of the collaborative prover.

The coefficients are public scalars, so the single prover's DSL types
serve unchanged: gadget code is the same for both provers."""

from ..r1cs.linear_combination import LinearCombination, Variable

MpcVariable = Variable
MpcLinearCombination = LinearCombination
