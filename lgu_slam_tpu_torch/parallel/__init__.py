"""Training of the PyTorch port (one process; DDP comes with the multi-GPU slice)."""
