"""Learning-rate schedules: functions of the update count.

Counterparts of what ``scripts/fe2s2_r3_push.py`` passes to
``optax.adamw``.  ``VMC`` sets update k's learning rate to
``schedule(k)``, k counted from 0 and restored on resume, as optax
evaluates a schedule at the count of the updates before it.
"""

from __future__ import annotations

import math

__all__ = ["exponential_decay", "ref_schedule"]


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float,
                      end_value: float | None = None):
    """``optax.exponential_decay`` without staircase or begin: init ·
    rate^(count / steps), and init at count ≤ 0; constant, as optax's,
    for steps ≤ 0 or rate 0.  ``end_value`` bounds it, as optax's: from
    below for a rate under 1, from above otherwise."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: float(init_value)
    clip = max if decay_rate < 1 else min

    def schedule(count: int) -> float:
        v = float(init_value) if count <= 0 else init_value * decay_rate ** (count / transition_steps)
        return v if end_value is None else clip(v, float(end_value))

    return schedule


def ref_schedule(lr: float, lr_end: float):
    """The reference flagship's schedule, max(lr · e^(−5e-4 · count), lr_end)
    (``scripts/fe2s2_r3_push.py --sched ref``)."""

    def schedule(count: int) -> float:
        return max(lr * math.exp(-5e-4 * count), lr_end)

    return schedule
