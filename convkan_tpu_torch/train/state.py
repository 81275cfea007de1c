"""Train state and optimizer, port of ``convkan_tpu/train/state.py``:
AdamW with a step-keyed learning-rate schedule (by default the reference's
per-epoch ExponentialLR, generic_train.py:24-26).

``torch.optim.AdamW`` with b1 0.9, b2 0.999, eps 1e-8 and decoupled weight
decay on every parameter is optax's ``adamw`` (which decays every leaf).
The schedule is a function of the step count n (starting at 0, as optax's
count does) and is written into the optimizer before each update, on the
host: no device sync.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
from torch import nn


def make_lr_schedule(learning_rate: float, gamma: float,
                     steps_per_epoch: int, scheduler: str = "exponential",
                     warmup_epochs: int = 0,
                     total_epochs: Optional[int] = None
                     ) -> Callable[[int], float]:
    """Step -> learning rate.  'exponential': lr * gamma^floor(n / spe);
    'cosine': cosine decay from lr to 0 over total_epochs; warmup_epochs > 0
    prepends a linear 0 -> lr ramp (optax's join_schedules)."""
    spe = max(steps_per_epoch, 1)
    if scheduler == "exponential":
        def main(n):
            return learning_rate * gamma ** (n // spe)
    elif scheduler == "cosine":
        if total_epochs is None:
            raise ValueError("scheduler='cosine' needs total_epochs")
        decay = max((total_epochs - warmup_epochs) * spe, 1)

        def main(n):
            return learning_rate * (0.5 * (
                1.0 + math.cos(math.pi * min(n, decay) / decay)))
    else:
        raise ValueError(f"unknown scheduler {scheduler!r} "
                         "(exponential | cosine)")
    if warmup_epochs <= 0:
        return main
    ws = warmup_epochs * spe

    def schedule(n):
        if n < ws:
            return -learning_rate * (1.0 - n / ws) + learning_rate
        return main(n - ws)

    return schedule


def make_optimizer(params, learning_rate: float, weight_decay: float
                   ) -> torch.optim.Optimizer:
    """AdamW over ``params`` (b1 0.9, b2 0.999, eps 1e-8, decoupled decay
    on every parameter); the learning rate is set per step by TrainState."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


@dataclasses.dataclass
class TrainState:
    """The model (holding the parameters and, with BatchNorm, the running
    statistics: buffers, which the optimizer does not see), its optimizer,
    the learning-rate schedule, the number of updates taken, and the
    generator that draws crop offsets, flips, dropout and DropPath
    masks."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    generator: Optional[torch.Generator]
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer update with the gradients in ``.grad``, at the
        learning rate of the current step."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, learning_rate: float = 1e-3,
                       weight_decay: float = 1e-3, gamma: float = 0.8,
                       steps_per_epoch: int = 1,
                       scheduler: str = "exponential",
                       warmup_epochs: int = 0,
                       total_epochs: Optional[int] = None,
                       ema_decay: float = 0.0, clip_grad_norm: float = 0.0,
                       generator: Optional[torch.Generator] = None,
                       seed: int = 0) -> TrainState:
    """Train state for an already-built model (its weights were drawn from
    its own generator).  ``generator`` None: one on the model's device,
    seeded with ``seed``."""
    if ema_decay > 0:
        raise NotImplementedError("ema_decay > 0 (parameter EMA) is not "
                                  "ported yet")
    if clip_grad_norm > 0:
        raise NotImplementedError("clip_grad_norm > 0 is not ported yet")
    if generator is None:
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(seed)
    schedule = make_lr_schedule(learning_rate, gamma, steps_per_epoch,
                                scheduler, warmup_epochs, total_epochs)
    return TrainState(model=model,
                      optimizer=make_optimizer(model.parameters(),
                                               learning_rate, weight_decay),
                      schedule=schedule, generator=generator)
