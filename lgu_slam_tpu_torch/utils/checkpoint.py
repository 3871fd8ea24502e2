"""Checkpoints and weights (port of the JAX package's
``utils/checkpoint.py``).

Training checkpoints (``save_train_state`` / ``load_train_state``) use the
port's own ``torch.save`` format: the model's state dict, the optimizer's
(AdamW moments and the schedule position), the step and the host data RNG's
state, so that a killed run resumes exactly.  A model under
``DistributedDataParallel`` is stored and loaded as the module it wraps,
without the ``module.`` prefix, so that one-process runs and the weight
bridge read its checkpoints.

Weights for inference come in two forms, both returned as the state dict
that ``LGUNet.load_state_dict(..., strict=True)`` takes
(:func:`load_weights` tells them apart by content):

- a reference ``.pth`` (:func:`load_reference_checkpoint`), or a train
  state of the port;
- a JAX params pickle, as the JAX package's ``save_params`` writes it
  (:func:`load_jax_params`), read without JAX.
"""

from __future__ import annotations

import pickle
import zipfile

import numpy as np
import torch

from lgu_slam_tpu_torch.utils.weights import state_dict_from_jax_params

# the reference trims these heads to their first 2 outputs at load time
TRIMMED_HEADS = ("update.weight.2", "update.delta.2")


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module inside a ``DistributedDataParallel`` wrapper."""
    return getattr(model, "module", model)


def save_train_state(path, model, opt, step: int, rng_state=None) -> None:
    torch.save({"model": unwrap(model).state_dict(),
                "optimizer": opt.state_dict(),
                "step": int(step), "rng_state": rng_state}, path)


def load_train_state(path, model, opt):
    """Loads the model and the optimizer in place.  Returns (step,
    rng_state)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    unwrap(model).load_state_dict(state["model"])
    opt.load_state_dict(state["optimizer"])
    return state["step"], state["rng_state"]


def load_reference_checkpoint(path) -> dict:
    """A reference LGU-SLAM ``.pth`` state dict (or a train state of the
    port, whose ``"model"`` it takes) -> the port's state dict: the
    ``module.`` prefix stripped and the weight/delta heads trimmed to 2
    outputs, as the JAX package's ``convert_torch_checkpoint`` does.  A KAN
    ``grid`` buffer loads as it is, adapted or uniform: the port's
    ``KANLinear`` evaluates the grid it holds, where the JAX converter
    refuses an adapted one."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    sd = {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}
    for head in TRIMMED_HEADS:
        for part in (".weight", ".bias"):
            sd[head + part] = sd[head + part][:2]
    return sd


def _reconstruct_array(fun, args, arr_state, aval_state):
    """numpy stand-in for ``jax._src.array._reconstruct_array``: the numpy
    value a pickled JAX array holds (its abstract value is not needed)."""
    value = fun(*args)
    value.__setstate__(arr_state)
    return value


# the globals a JAX params pickle names, mapped to numpy; numpy's array
# reconstructor is pickled under numpy._core (numpy 2) or numpy.core (1.x)
_RECONSTRUCT = np.empty(0).__reduce__()[0]
_PARAMS_GLOBALS = {
    ("jax._src.array", "_reconstruct_array"): _reconstruct_array,
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
    ("numpy._core.multiarray", "_reconstruct"): _RECONSTRUCT,
    ("numpy.core.multiarray", "_reconstruct"): _RECONSTRUCT,
}


class _ParamsUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays and JAX arrays (as numpy) in dicts, lists and
    tuples; refuses every other global."""

    def find_class(self, module, name):
        try:
            return _PARAMS_GLOBALS[module, name]
        except KeyError:
            raise pickle.UnpicklingError(
                f"refused global {module}.{name}: a JAX params pickle holds "
                "arrays only") from None


def load_jax_params(path) -> dict:
    """A JAX params pickle (``{"params": tree}``, the JAX package's
    ``save_params``) -> the port's state dict, through ``utils/weights.py``;
    JAX need not be installed."""
    with open(path, "rb") as fh:
        obj = _ParamsUnpickler(fh).load()
    if not isinstance(obj, dict) or "params" not in obj:
        raise ValueError(f"{path}: not a JAX params pickle")
    return state_dict_from_jax_params(obj["params"])


def load_weights(path) -> dict:
    """``--weights`` of the entry points: a zip archive (what ``torch.save``
    writes) is a reference ``.pth`` or a train state of the port, anything
    else a JAX params pickle."""
    if zipfile.is_zipfile(path):
        return load_reference_checkpoint(path)
    return load_jax_params(path)
