"""Weight bridge: the JAX package's parameter tree -> a state dict in
the reference torch layout, which ``LGUNet.load_state_dict(strict=True)``
takes.

It is the exact inverse of ``convert_torch_checkpoint``
(the JAX package's ``utils/checkpoint.py``): HWIO conv kernels become OIHW,
dense and KAN weights are transposed back, the reference key names are
used, and the delta and weight heads stay at 2 channels.  The input is the
tree as numpy arrays (``jax.device_get(params)``); nothing here imports JAX.
``conv_gru_state_dict`` bridges a lone ``ConvGRU`` cell the same way.
A 3DGS ``GaussianMap`` crosses both ways with ``gaussian_map_from_numpy``
and ``gaussian_map_to_numpy``.
"""

from __future__ import annotations

import numpy as np
import torch

GRID_SIZE = 3
SPLINE_ORDER = 3


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(sd: dict, key: str, p) -> None:
    sd[key + ".weight"] = _t(np.transpose(np.asarray(p["kernel"]),
                                          (3, 2, 0, 1)))
    sd[key + ".bias"] = _t(p["bias"])


def _dense(sd: dict, key: str, p) -> None:
    sd[key + ".weight"] = _t(np.transpose(np.asarray(p["kernel"]), (1, 0)))
    sd[key + ".bias"] = _t(p["bias"])


def _kan(sd: dict, key: str, p) -> None:
    base = np.asarray(p["base_weight"])  # [I, O]
    sd[key + ".base_weight"] = _t(base.T)
    sd[key + ".spline_weight"] = _t(
        np.transpose(np.asarray(p["spline_weight"]), (2, 0, 1)))
    sd[key + ".spline_scaler"] = _t(np.asarray(p["spline_scaler"]).T)
    h = 2.0 / GRID_SIZE
    grid = np.arange(-SPLINE_ORDER, GRID_SIZE + SPLINE_ORDER + 1) * h - 1.0
    sd[key + ".grid"] = _t(np.tile(grid, (base.shape[0], 1)))


def _encoder(sd: dict, key: str, p) -> None:
    _conv(sd, key + ".conv1", p["conv1"])
    _conv(sd, key + ".conv2", p["conv2"])
    for stage in (1, 2, 3):
        for blk in (0, 1):
            src = p[f"layer{stage}_{blk}"]
            dst = f"{key}.layer{stage}.{blk}"
            _conv(sd, dst + ".conv1", src["conv1"])
            _conv(sd, dst + ".conv2", src["conv2"])
            if "downsample" in src:
                _conv(sd, dst + ".downsample.0", src["downsample"])


def state_dict_from_jax_params(params) -> dict:
    """Flax LGUNet params (numpy leaves) -> reference-layout state dict."""
    sd: dict = {}
    _encoder(sd, "fnet", params["fnet"])
    _encoder(sd, "cnet", params["cnet"])
    for name in ("map", "meanMap", "covMap"):
        _dense(sd, f"GA.{name}", params["ga"][name])
    _conv(sd, "ofsMap", params["ofs_map"])
    _conv(sd, "ofs_residual", params["ofs_residual"])
    up = params["update"]
    for src, dst in (("corr_enc1", "corr_encoder.0"),
                     ("corr_enc2", "corr_encoder.2"),
                     ("flow_enc1", "flow_encoder.0"),
                     ("flow_enc2", "flow_encoder.2"),
                     ("weight1", "weight.0"), ("weight2", "weight.2"),
                     ("delta1", "delta.0"), ("delta2", "delta.2")):
        _conv(sd, f"update.{dst}", up[src])
    for name in ("convz", "convr", "convq", "w"):
        _conv(sd, f"update.gru.{name}", up["gru"][name])
    for name in ("kanz_glo", "kanr_glo", "kanq_glo"):
        _kan(sd, f"update.gru.{name}", up["gru"][name])
    _conv(sd, "update.agg.conv1", up["agg"]["conv1"])
    _conv(sd, "update.agg.conv2", up["agg"]["conv2"])
    _conv(sd, "update.agg.eta.0", up["agg"]["eta"])
    _conv(sd, "update.agg.upmask.0", up["agg"]["upmask"])
    return sd


def conv_gru_state_dict(params) -> dict:
    """A JAX ``ConvGRU`` cell's params (numpy leaves) -> the state dict of
    the port's ``models.gru.ConvGRU`` (the reference's key names)."""
    sd: dict = {}
    for name in ("convz", "convr", "convq", "convz_glo", "convr_glo",
                 "convq_glo"):
        _conv(sd, name, params[name])
    return sd


def gaussian_map_from_numpy(params: dict, alive, count: int, timestep,
                            device) -> "GaussianMap":
    """A JAX package ``GaussianMap``'s state -- its parameter dict as numpy
    (``jax.device_get(map.params)``), ``alive``, ``count`` and
    ``timestep`` -- as the port's ``GaussianMap`` on ``device``.  Both keep
    the same keys, shapes and slot layout."""
    from lgu_slam_tpu_torch.gs.params import PARAM_KEYS, GaussianMap

    tensors = {k: torch.as_tensor(np.array(params[k], np.float32),
                                  device=device) for k in PARAM_KEYS}
    return GaussianMap(tensors, np.array(alive, bool), int(count),
                       tensors["means3D"].shape[0],
                       np.array(timestep, np.float32))


def gaussian_map_to_numpy(gmap) -> tuple:
    """The inverse: (params as numpy, alive, count, timestep), the fields
    of the JAX package's ``GaussianMap``."""
    params = {k: v.detach().cpu().numpy().copy()
              for k, v in gmap.params.items()}
    return params, gmap.alive.copy(), gmap.count, gmap.timestep.copy()
