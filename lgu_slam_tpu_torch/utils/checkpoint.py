"""Training checkpoints (port of ``save_train_state`` / ``load_train_state``
of the JAX package's ``utils/checkpoint.py``) in the port's own
``torch.save`` format: the model's state dict, the optimizer's (AdamW
moments and the schedule position), the step and the host data RNG's state,
so that a killed run resumes exactly."""

from __future__ import annotations

import torch


def save_train_state(path, model, opt, step: int, rng_state=None) -> None:
    torch.save({"model": model.state_dict(), "optimizer": opt.state_dict(),
                "step": int(step), "rng_state": rng_state}, path)


def load_train_state(path, model, opt):
    """Loads the model and the optimizer in place.  Returns (step,
    rng_state)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"])
    opt.load_state_dict(state["optimizer"])
    return state["step"], state["rng_state"]
