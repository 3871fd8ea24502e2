"""geom layer of the PyTorch port."""
