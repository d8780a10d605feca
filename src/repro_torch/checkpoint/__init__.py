"""checkpoint of the PyTorch port."""
