"""Build and load the port's CUDA kernels.

Each ``lgu_slam_tpu_torch/csrc/<name>.cu`` exposes a plain C function and is
compiled by nvcc into its own shared library under
``build/lgu_slam_tpu_torch/`` beside the package (in a checkout, the
checkout's ``build/``; in an installed copy, ``build/`` in the directory
that holds the installed package, which must then be writable), then
loaded with ``ctypes``.  The sources ship with the package.
Nothing is built when a module is imported: the first launch on a CUDA
tensor builds its kernel, and :func:`build_all` builds every kernel at once
(one nvcc process per source, all started together).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lgu_slam_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """Missing, or older than its source or any shared header."""
    lib = _target(name)
    if not lib.exists():
        return True
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def _start(name: str) -> tuple[subprocess.Popen, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, _target(name))  # atomic: concurrent builds race safely
    return log


def build_all(names) -> dict[str, str]:
    """Compile the named kernels in parallel; returns nvcc's log (the
    ``-Xptxas -v`` register/shared-memory summary) per kernel."""
    started = {n: _start(n) for n in names}
    return {n: _finish(n, *started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing or
    older than its source."""
    lib = _loaded.get(name)
    if lib is None:
        if _stale(name):
            _finish(name, *_start(name))
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib


def check(status: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{status}")
