"""data layer of the PyTorch port (see the package docstring)."""
