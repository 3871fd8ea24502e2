"""PyTorch/CUDA port of the JAX package for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout
(``lie/ geom/ models/ ops/ slam/ parallel/ data/ utils/``) and imports
nothing of it.  Every Pallas kernel of the JAX package is a hand-written
CUDA kernel under ``csrc/``, built with nvcc on first use (see
``ops/_build.py``).
"""
