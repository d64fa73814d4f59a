"""Learning-rate schedules as plain functions of the 0-based global step.

Counterpart of satnerf_tpu/train/schedules.py (reference
train_utils.get_scheduler, train_utils.py:41-57): 'step' (the one the
reference uses: gamma 0.9 per epoch), 'cosine', 'exponential', 'multistep'.
`spe` (steps per epoch) converts the reference's per-epoch semantics.

Not torch.optim.lr_scheduler: the train step reads the schedule at the step
counter before its increment and sets param_group["lr"] from it, which the
schedulers' own epoch bookkeeping would put one step off.
"""

from __future__ import annotations

import math


def get_schedule(name: str, lr: float, num_epochs: int, spe: int):
    eps = 1e-8

    if name == "cosine":
        def schedule(step: int) -> float:
            epoch = min(step // spe, num_epochs)
            return eps + 0.5 * (lr - eps) * (
                1.0 + math.cos(math.pi * epoch / max(num_epochs, 1)))

    elif name == "exponential":
        def schedule(step: int) -> float:
            return lr * 0.01 ** (step // spe)

    elif name == "multistep":
        def schedule(step: int) -> float:
            epoch = step // spe
            return lr * 0.5 ** sum(epoch >= m for m in (2, 4, 8))

    elif name == "step":
        def schedule(step: int) -> float:
            return lr * 0.9 ** (step // spe)

    else:
        raise ValueError("lr scheduler not recognized!")

    return schedule
