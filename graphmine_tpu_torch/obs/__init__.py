"""Result-quality observability of the PyTorch port (stdlib and NumPy)."""
