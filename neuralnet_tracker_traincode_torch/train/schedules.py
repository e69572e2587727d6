"""Learning-rate schedules (counterpart of the JAX package's
`train/schedules.py`, copied: it is plain Python).

Schedules are functions of the EPOCH index returning an lr multiplier (the
reference steps its schedulers once per epoch).
"""

import math
from typing import Callable, Sequence


def exponential_up_then_steps(num_up: int, gamma: float, steps: Sequence[int]) -> Callable[[int], float]:
    """Exponential ramp from 1e-2x over `num_up` epochs, then x gamma at each step."""
    steps = [0] + list(steps)

    def lr_func(i: int) -> float:
        eps = 1.0e-2
        scale = math.log(eps)
        if i < num_up:
            f = (i + 1) / num_up
            return eps * math.exp(-scale * f)
        step_index = [j for j, step in enumerate(steps) if i > step][-1]
        return gamma**step_index

    return lr_func


def linear_up_then_steps(num_up: int, gamma: float, steps: Sequence[int]) -> Callable[[int], float]:
    steps = [0] + list(steps)

    def lr_func(i: int) -> float:
        if i < num_up:
            return (i + 1) / num_up
        step_index = [j for j, step in enumerate(steps) if i > step][-1]
        return gamma**step_index

    return lr_func


def triangular(min_lr_factor: float, num_epochs: int) -> Callable[[int], float]:
    """CyclicLR 'triangular' with one cycle: up 30% (capped 33 epochs), down the rest."""
    num_up = min(max(1, num_epochs * 3 // 10), 33)
    num_down = max(1, num_epochs - num_up)

    def lr_func(i: int) -> float:
        if i < num_up:
            f = i / num_up
        else:
            f = max(0.0, 1.0 - (i - num_up) / num_down)
        return min_lr_factor + (1.0 - min_lr_factor) * f

    return lr_func
