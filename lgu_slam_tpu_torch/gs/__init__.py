"""3-D Gaussian Splatting stage of the PyTorch port: SplaTAM-style mapping
over a saved SLAM reconstruction, TSDF meshing and render evaluation
(port of the JAX package's ``gs/``)."""
