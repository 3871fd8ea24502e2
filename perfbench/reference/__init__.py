"""The plain reference that decides whether a benchmark run is correct.

A frozen copy of the plain paths of ``lgu_slam_tpu_torch`` (the paths its
CPU tests hold to the JAX package): every module here is the port's module
of the same name, on one device, with the hand-written kernels replaced by
their plain PyTorch formulas, the planner in Python, and every stored or
computed precision emulated in float32 (``precision.py``).  It imports
nothing of the port and takes nothing the port made: the benchmark hands
both the same weights and inputs.
"""
