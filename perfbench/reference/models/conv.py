"""NHWC convolution used by every network module of the port.

The port keeps the JAX package's NHWC layout at its public functions and
permutes to NCHW only around ``F.conv2d`` (a permuted NHWC tensor is a
channels-last NCHW tensor, which cuDNN takes without a copy).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.precision import rnd


class Conv(nn.Conv2d):
    """``nn.Conv2d`` on NHWC tensors.  ``dtype`` is the compute dtype: input,
    weight, bias and output are rounded to it, the product computed in
    float32 (:func:`~perfbench.reference.precision.rnd`); ``None`` is
    float32."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype | None = None):
        super().__init__(cin, cout, k, stride=stride, padding=padding)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.conv2d(rnd(x.permute(0, 3, 1, 2), dt), rnd(self.weight, dt),
                     rnd(self.bias, dt), self.stride, self.padding)
        return rnd(y, dt).permute(0, 2, 3, 1)
