"""Learning-rate schedules and optimizers of the training step.

Counterpart of ``mdhs_tpu/train/optim.py``:

- ``cosine`` (epoch-stepped CosineAnnealingLR over ``num_epochs``),
  ``warmup_cosine`` (per-step linear warmup, then cosine) and ``constant``;
  ``make_schedule`` falls back to ``constant`` for a missing or unknown name,
  as the reference does. A schedule maps the number of updates already made
  to a learning rate (a Python float).
- ``make_optimizer``: Adam, AdamW (weight decay ``training.weight_decay``,
  0.01 by default, torch's) and SGD on ``torch.optim``. optax's
  ``scale_by_learning_rate`` reads the schedule at the update count before
  each update; ``set_learning_rate`` does the same to the torch optimizer's
  param groups, and the trainer calls it before every step.

Muon, the flattened optimizer update and the encoder freeze mask raise
``NotImplementedError`` (ROADMAP Queue 1 item 8, still open after the MIBF
training step).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch

Schedule = Callable[[int], float]


def cosine_schedule(base_lr: float, *, num_epochs: int, steps_per_epoch: int, **_) -> Schedule:
    """lr(step) = base * (1 + cos(pi * epoch / num_epochs)) / 2, epoch = step // steps_per_epoch."""

    def fn(step: int) -> float:
        epoch = math.floor(step / max(1, steps_per_epoch))
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / max(1, num_epochs)))

    return fn


def warmup_cosine_schedule(base_lr: float, *, num_epochs: int, steps_per_epoch: int,
                           warmup_epochs: int = 5, **_) -> Schedule:
    """Linear warmup over warmup_epochs * steps_per_epoch steps, then cosine to 0."""
    total_steps = num_epochs * steps_per_epoch
    warmup_steps = min(int(warmup_epochs * steps_per_epoch), total_steps)

    def fn(step: int) -> float:
        if step < warmup_steps:
            return base_lr * (step + 1.0) / max(1, warmup_steps)
        cosine_steps = max(1, total_steps - warmup_steps)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * (step - warmup_steps) / cosine_steps))

    return fn


def constant_schedule(base_lr: float, **_) -> Schedule:
    return lambda step: float(base_lr)


SCHEDULES = {"cosine": cosine_schedule, "warmup_cosine": warmup_cosine_schedule,
             "constant": constant_schedule}


def make_schedule(name: Optional[str], base_lr: float, **kwargs) -> Schedule:
    if not name:
        return constant_schedule(base_lr)
    key = name.lower().replace("-", "_")
    if key not in SCHEDULES:
        return constant_schedule(base_lr)  # the reference logs "unrecognized scheduler" and goes on
    return SCHEDULES[key](base_lr, **kwargs)


def make_optimizer(name: str, params: Iterable[torch.Tensor], base_lr: float,
                   weight_decay: float = 0.01) -> torch.optim.Optimizer:
    """Adam / AdamW / SGD by the reference's name, at optax's defaults
    (betas 0.9 / 0.999, eps 1e-8; SGD without momentum)."""
    key = name.lower()
    if key == "adam":
        return torch.optim.Adam(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8)
    if key == "adamw":
        return torch.optim.AdamW(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    if key == "sgd":
        return torch.optim.SGD(params, lr=base_lr)
    if key == "muon":
        raise NotImplementedError("the Muon optimizer is not ported yet: ROADMAP Queue 1 item 8")
    raise ValueError(f"unknown optimizer {name!r}: expected Adam, AdamW or SGD")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
