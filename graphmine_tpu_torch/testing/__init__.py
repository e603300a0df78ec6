"""Test support of the PyTorch port: deterministic fault injection."""
