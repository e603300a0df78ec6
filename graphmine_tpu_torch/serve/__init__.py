"""Serving plane of the PyTorch port: the versioned snapshot store."""
