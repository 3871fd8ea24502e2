"""PyTorch/CUDA port of the JAX package for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout
(``lie/ geom/ models/ ops/ slam/ utils/``) and imports nothing of it.  The
two Pallas kernels on the tracking path are hand-written CUDA kernels under
``csrc/``, built with nvcc on first use (see ``ops/_build.py``).
"""
