"""The vendor baseline: cuDNN and cuBLAS, the role cuDNN plays in the
reference repo and XLA in the JAX package."""
