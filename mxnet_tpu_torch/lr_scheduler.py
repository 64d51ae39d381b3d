"""Learning-rate schedules.

Counterpart of ``mxnet_tpu/lr_scheduler.py:12-68`` (reference
python/mxnet/lr_scheduler.py): ``LRScheduler``, ``FactorScheduler`` and
``MultiFactorScheduler``, the schedules the image-classification
harness builds (``common/fit.py``).  The optimizer calls a schedule
with its update count and sets its ``base_lr`` to its learning rate.
The polynomial, cosine and warm-up schedules come with a later slice.
"""
from __future__ import annotations


__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler"]


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
