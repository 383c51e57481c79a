"""Field, curve, keccak and transcript layers, the MSMs and the CUDA kernels."""
