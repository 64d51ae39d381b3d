"""Learning-rate schedules.

Counterpart of ``mxnet_tpu/lr_scheduler.py`` (reference
python/mxnet/lr_scheduler.py): ``LRScheduler``, ``FactorScheduler`` and
``MultiFactorScheduler``, the schedules the image-classification
harness builds (``common/fit.py``), and ``PolyScheduler``,
``CosineScheduler`` and ``WarmupScheduler``, those LM training uses.
The optimizer calls a schedule with its update count and sets its
``base_lr`` to its learning rate (a ``WarmupScheduler``'s: the schedule
it wraps keeps the ``base_lr`` it was made with, as in the reference).
In the fused fit step the rate reaches the graph as a runtime value, so
a schedule never captures again.
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler", "WarmupScheduler"]


class LRScheduler:
    """Maps ``num_update`` (the optimizer's update counter) to a learning
    rate.  Stateful: the rate never rewinds if ``num_update`` goes
    back."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """Geometric decay: multiply by ``factor`` once per ``step`` updates,
    floored at ``stop_factor_lr``."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01):
        super().__init__(base_lr)
        if step < 1:
            raise ValueError("step must be >= 1")
        if factor > 1.0:
            raise ValueError("factor must be <= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self._decays_applied = 0

    def __call__(self, num_update):
        # decays owed so far: one per whole `step` strictly before num_update
        due = max(0, num_update - 1) // self.step
        while self._decays_applied < due:
            self._decays_applied += 1
            self.base_lr = max(self.base_lr * self.factor,
                               self.stop_factor_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """Multiply by ``factor`` as ``num_update`` passes each boundary in the
    increasing list ``step``."""

    def __init__(self, step, factor=1.0, base_lr=0.01):
        super().__init__(base_lr)
        if any(a >= b for a, b in zip(step, step[1:])):
            raise ValueError("steps must be increasing")
        self.step = list(step)
        self.factor = factor
        self._next_boundary = 0

    def __call__(self, num_update):
        while (self._next_boundary < len(self.step)
               and num_update > self.step[self._next_boundary]):
            self._next_boundary += 1
            self.base_lr *= self.factor
        return self.base_lr


class _AnnealingScheduler(LRScheduler):
    """Anneals from ``base_lr`` to ``final_lr`` over ``max_update``
    updates along a shape on [0, 1] that subclasses give; past
    ``max_update`` the rate stays where it ended."""

    def __init__(self, max_update, base_lr, final_lr):
        super().__init__(base_lr)
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr

    def _shape(self, t):
        """The fraction of the span left at progress ``t``."""
        raise NotImplementedError

    def __call__(self, num_update):
        if num_update <= self.max_update:
            span = self.base_lr_orig - self.final_lr
            self.base_lr = self.final_lr + \
                span * self._shape(num_update / self.max_update)
        return self.base_lr


class PolyScheduler(_AnnealingScheduler):
    """Polynomial decay: the span times ``(1 - t)^pwr``."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0):
        super().__init__(max_update, base_lr, final_lr)
        self.power = pwr

    def _shape(self, t):
        return (1 - t) ** self.power


class CosineScheduler(_AnnealingScheduler):
    """Half-cosine decay: the span times ``(1 + cos(pi t)) / 2``."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0):
        super().__init__(max_update, base_lr, final_lr)

    def _shape(self, t):
        return (1 + math.cos(math.pi * t)) / 2


class WarmupScheduler(LRScheduler):
    """A linear ramp from ``warmup_begin_lr`` to the wrapped schedule's
    ``base_lr`` over ``warmup_steps`` updates, then the wrapped
    schedule."""

    def __init__(self, scheduler, warmup_steps, warmup_begin_lr=0.0):
        super().__init__(scheduler.base_lr)
        self.scheduler = scheduler
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr

    def __call__(self, num_update):
        if num_update >= self.warmup_steps:
            return self.scheduler(num_update)
        ramp = num_update / self.warmup_steps
        return self.warmup_begin_lr + \
            ramp * (self.scheduler.base_lr - self.warmup_begin_lr)
