"""slam layer of the PyTorch port."""
