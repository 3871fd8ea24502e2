"""Training metrics logger (port of the JAX package's ``utils/logger.py``):
100-step running means to JSONL and stdout, and to TensorBoard where
``torch.utils.tensorboard`` imports."""

from __future__ import annotations

import json
import os
import time

SUM_FREQ = 100


class Logger:
    def __init__(self, name: str, logdir: str = "runs"):
        self.name = name
        self.running = {}
        self.count = 0
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, f"{name}.jsonl")
        self.writer = None
        try:  # TensorBoard if available (torch is baked in)
            from torch.utils.tensorboard import SummaryWriter  # noqa: PLC0415

            self.writer = SummaryWriter(os.path.join(logdir, name))
        except Exception:
            pass

    def push(self, metrics: dict, step: int):
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
        self.count += 1
        if self.count >= SUM_FREQ:
            means = {k: v / self.count for k, v in self.running.items()}
            means["step"] = step
            means["time"] = time.time()
            with open(self.path, "a") as f:
                f.write(json.dumps(means) + "\n")
            if self.writer is not None:
                for k, v in means.items():
                    if k not in ("step", "time"):
                        self.writer.add_scalar(k, v, step)
            print(f"[{self.name} step {step}] " + " ".join(
                f"{k}={v:.4f}" for k, v in means.items()
                if k not in ("step", "time")
            ))
            self.running = {}
            self.count = 0
