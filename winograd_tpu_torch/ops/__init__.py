"""Plain PyTorch operators (the vendor-baseline role)."""
