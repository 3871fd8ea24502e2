"""Trajectory evaluation (NumPy)."""
