"""Plain PyTorch operators (the vendor-baseline role) and the float64 numpy
golden models (reference.py)."""
