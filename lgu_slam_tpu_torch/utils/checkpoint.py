"""Training checkpoints (port of ``save_train_state`` / ``load_train_state``
of the JAX package's ``utils/checkpoint.py``) in the port's own
``torch.save`` format: the model's state dict, the optimizer's (AdamW
moments and the schedule position), the step and the host data RNG's state,
so that a killed run resumes exactly.  A model under
``DistributedDataParallel`` is stored and loaded as the module it wraps,
without the ``module.`` prefix, so that one-process runs and the weight
bridge read its checkpoints."""

from __future__ import annotations

import torch


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
