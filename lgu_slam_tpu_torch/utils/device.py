"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for another device;
with no device given and no CUDA, they raise instead of drifting to the CPU.
"""

from __future__ import annotations

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


def use_full_fp32() -> None:
    """fp32 matmuls and convolutions run in full fp32 on the card (TF32 off),
    so the DBA and KAN paths compute what the JAX reference computes; the
    bf16 conv path is unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
