"""Hand-written CUDA kernels for Hopper, their plain twins, and dispatch."""
