"""Multi-device paths of the PyTorch port: the sharded DBA, the sharded
backend pass and the (data-parallel) training step."""
