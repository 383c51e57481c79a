"""The protocols: the inner-product argument and the range prover."""
