"""optim of the PyTorch port."""
