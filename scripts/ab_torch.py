"""What the A/B scripts share (``ab_k1_torch.py``, ``ab_k2_torch.py``,
``ab_lookup_torch.py``): each times kernels built from another revision's
sources against this checkout's on one card, in mirrored turns (parent,
change, change, parent), beside designs tried and not kept
(``--variant NAME=DIR``)."""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from lgu_slam_tpu_torch.ops import _build  # noqa: E402


def turns(tags) -> tuple:
    """``tags`` and then the same in reverse: a drift of the card over the
    run shifts every tag alike."""
    return (*tags, *reversed(tags))


def arguments(parent_help: str, variant_help: str, out: bool = False):
    """``--parent DIR``, ``--variant NAME=DIR`` (repeatable; returned as a
    dict NAME -> DIR) and, with ``out``, ``--out DIR``."""
    p = argparse.ArgumentParser()
    p.add_argument("--parent", required=True, help=parent_help)
    p.add_argument("--variant", action="append", default=[],
                   metavar="NAME=DIR", help=variant_help)
    if out:
        p.add_argument("--out", default="build",
                       help="directory for the JSON report")
    args = p.parse_args()
    args.variant = dict(spec.split("=", 1) for spec in args.variant)
    return args


def need_card(script: str) -> None:
    """Exit unless a card is there; make the build directory."""
    if not torch.cuda.is_available():
        sys.exit(f"{script}: needs an NVIDIA GPU")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)


def build(src: str, tag: str) -> ctypes.CDLL:
    """Compile ``src`` with the port's nvcc flags into
    ``build/lib<name>_ab_<tag>.so`` and load it; the source's own directory
    comes first on the include path, then the checkout's ``csrc/``.
    ptxas' register summary is printed."""
    name = os.path.splitext(os.path.basename(src))[0]
    out = str(_build.BUILD_DIR / f"lib{name}_ab_{tag}.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        str(_build.CSRC), "-o", out, src],
                       capture_output=True, text=True)
    if r.returncode != 0:
        sys.exit(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    print(tag, src, [line.strip() for line in
                     (r.stdout + r.stderr).splitlines()
                     if "registers" in line], flush=True)
    return ctypes.CDLL(out)


def entry(lib: ctypes.CDLL, name: str, n_ptr: int, n_int: int):
    """The C function ``name`` of ``lib`` taking ``n_ptr`` pointers,
    ``n_int`` ints and a stream, returning a CUDA status."""
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
        + [ctypes.c_void_p]
    return fn
