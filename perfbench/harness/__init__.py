"""The benchmark harness of ``lgu_slam_tpu_torch``: cells found by name,
inputs and weights made from the seed, the measured window, the traced
run's readings, and the comparison with the plain reference."""
