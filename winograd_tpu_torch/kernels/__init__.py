"""Hand-written Hopper kernels (csrc/) with their wrappers and plain
PyTorch versions."""
