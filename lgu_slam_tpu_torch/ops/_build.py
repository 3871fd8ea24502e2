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

Host helpers in plain C (``csrc/host/<name>.c``, such as the PNG row
unfilter) are built and loaded the same way by the host C compiler; a
failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lgu_slam_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# No FMA contraction: the host decoders round each product alone, as the
# readers they follow do (hdr_rgbe.c writes its one FMA with fmaf).
HOST_CFLAGS = ["-O2", "-std=c99", "-ffp-contract=off", "-shared", "-fPIC"]

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


def _cc() -> str:
    for name in (os.environ.get("CC"), "cc", "gcc"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C compiler found (cc, gcc or $CC): the port's "
                       "host helpers in csrc/host/ are built at first use")


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _source(name: str) -> Path:
    """``csrc/<name>.cu``, else the host helper ``csrc/host/<name>.c``."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / "host" / f"{name}.c"


def _stale(name: str) -> bool:
    """Missing, or older than its source or any shared header (CUDA's
    ``*.cuh``, the host helpers' ``host/*.h``)."""
    lib = _target(name)
    if not lib.exists():
        return True
    src = _source(name)
    sources = [src, *CSRC.glob("*.cuh")] if src.suffix == ".cu" else \
        [src, *(CSRC / "host").glob("*.h")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def _start(name: str) -> tuple[subprocess.Popen, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # per process and thread: two threads of a reader may build one library
    tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.{threading.get_ident()}.tmp"
    src = _source(name)
    compiler = [_nvcc(), *NVCC_FLAGS] if src.suffix == ".cu" else \
        [_cc(), *HOST_CFLAGS]
    proc = subprocess.Popen([*compiler, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"the build of "
                           f"{_source(name).relative_to(CSRC.parent)} "
                           f"failed:\n{log}")
    os.replace(tmp, _target(name))  # atomic: concurrent builds race safely
    return log


def build_all(names) -> dict[str, str]:
    """Compile the named kernels in parallel; returns nvcc's log (the
    ``-Xptxas -v`` register/shared-memory summary) per kernel."""
    started = {n: _start(n) for n in names}
    return {n: _finish(n, *started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel or host helper ``name``, built first if
    missing or older than its source."""
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
