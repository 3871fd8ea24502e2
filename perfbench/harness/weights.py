"""LGUNet weights made from the seed on the device, in a few large calls.

The parameter list is the reference network's (the original model's state
dict layout, which the port loads as it is).  Kernels of convolutions and
linear layers are lecun-normal (a standard normal clipped at +-2 and
rescaled to variance 1 / fan_in), biases zero, KAN base weights and spline
scalers lecun-normal, KAN spline weights N(0, 0.02), and the KAN grids the
uniform grid over [-1, 1] that every KAN layer starts from.  Unlike the
port's ``init_state_dict``, the FPN offset heads and the Gaussian mean head
are random too, so that the deformable taps and the Gaussian window move
off the pixel grid as a trained network's do.
"""

from __future__ import annotations

import math

import torch

KAN_GRID_SIZE = 3
KAN_ORDER = 3
TRUNC_STD = 0.87962566103423978  # sd of a standard normal truncated at +-2


def parameter_shapes() -> dict:
    """name -> shape of every entry of the network's state dict."""
    from perfbench.reference.models.net import LGUNet
    net = LGUNet(device="meta")
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}


def _fan_in(name: str, shape: tuple) -> int:
    if name.endswith(("spline_scaler", "base_weight")):
        return shape[1]
    return math.prod(shape[1:])


def make_state_dict(seed: int, device) -> dict:
    """The weights of ``seed``: one normal draw for everything on the
    device, sliced and scaled per entry."""
    shapes = parameter_shapes()
    random = {k: s for k, s in shapes.items()
              if k.endswith((".weight", "base_weight", "spline_weight",
                             "spline_scaler"))}
    total = sum(math.prod(s) for s in random.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name in random:
            n = math.prod(shape)
            z = draw[at:at + n].reshape(shape)
            at += n
            if name.endswith("spline_weight"):
                out[name] = 0.02 * z
            else:
                std = math.sqrt(1.0 / _fan_in(name, shape)) / TRUNC_STD
                out[name] = std * z.clamp(-2.0, 2.0)
        elif name.endswith(".grid"):
            h = 2.0 / KAN_GRID_SIZE
            knots = torch.arange(-KAN_ORDER, KAN_GRID_SIZE + KAN_ORDER + 1,
                                 dtype=torch.float64) * h - 1.0
            out[name] = knots.float().to(device).expand(shape).contiguous()
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
