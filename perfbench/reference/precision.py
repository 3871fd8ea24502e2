"""Rounding to a storage or compute precision, emulated in float32.

The reference computes in float32 and rounds a value to the configuration's
dtype where the configuration stores or computes in that dtype: features,
correlation volumes, the backend's hidden state and the convolutions'
operands and results.  For ``float32`` this is the identity, which is the
reference; a lower dtype (``float8_e4m3fn`` for the bf16 configuration)
gives the control that the comparison has to reject.  Values beyond the
dtype's range saturate at its largest finite value.
"""

from __future__ import annotations

import torch


def as_dtype(dtype) -> torch.dtype | None:
    """A torch dtype from a dtype or its name (``None`` stays ``None``)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, dtype)


def rnd(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and widened back to float32."""
    dt = as_dtype(dtype)
    x = x.float()
    if dt is None or dt == torch.float32:
        return x
    big = torch.finfo(dt).max
    return x.clamp(-big, big).to(dt).float()
