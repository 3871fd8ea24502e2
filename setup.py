"""Build for lgu_slam_tpu + the native host-side planner extension.

Reference counterpart: the reference builds two CUDA extensions
(setup.py:7-32 -> droid_backends; offersample_LGS/setup.py -> defCorrSample).
Here all device kernels are JAX/XLA/Pallas; the native extension covers the
host-side graph planning (factor-graph NMS, DBA row grouping).
"""

from setuptools import Extension, find_packages, setup

setup(
    name="lgu_slam_tpu",
    version="0.1.0",
    description="TPU-native deep visual SLAM (LGU-SLAM capabilities)",
    # lgu_slam_tpu_torch: the PyTorch/CUDA port; its CUDA kernels build
    # from the shipped csrc/*.cu with nvcc at first use on the GPU, not here
    packages=find_packages(include=["lgu_slam_tpu", "lgu_slam_tpu.*",
                                    "lgu_slam_tpu_torch",
                                    "lgu_slam_tpu_torch.*"]),
    package_data={"lgu_slam_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    ext_modules=[
        Extension(
            "lgu_native",
            sources=["native/lgu_native.cpp"],
            extra_compile_args=["-O3", "-std=c++17"],
        )
    ],
    python_requires=">=3.10",
)
