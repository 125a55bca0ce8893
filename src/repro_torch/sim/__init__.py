"""sim layer of the PyTorch port: the device profiles the pool reads."""
