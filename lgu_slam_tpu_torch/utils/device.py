"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for another device;
with no device given and no CUDA, they raise instead of drifting to the CPU.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the first CUDA device; a CUDA device raises when CUDA is
    absent; anything else is taken as given (``"cpu"`` in the tests)."""
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the port "
                "on the CPU with the kernels' plain PyTorch versions"
            )
        return torch.device("cuda" if device is None else device)
    return torch.device(device)


def to_device(x, device) -> torch.Tensor:
    """A tensor, an array or a sequence as a float32 tensor on ``device``."""
    if not torch.is_tensor(x):
        x = np.asarray(x, np.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def to_host(x) -> np.ndarray:
    """A tensor (detached, copied to the host) or an array as numpy."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def use_full_fp32() -> None:
    """fp32 matmuls and convolutions run in full fp32 on the card (TF32 off),
    so the DBA and KAN paths compute what the JAX reference computes; the
    bf16 conv path is unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def full_fp32_convs():
    """fp32 convolutions run in full fp32 (no TF32) inside the block, on
    the card as on the CPU; the flag is restored on exit.  cuDNN reads it
    when a convolution or its backward runs, so a differentiated caller
    keeps its backward inside the block too."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old
