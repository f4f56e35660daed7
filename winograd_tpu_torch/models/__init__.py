"""ResNet-50 composed from the port's kernels."""
