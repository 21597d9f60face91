"""Learning-rate schedules (counterpart of ``mxnet_tpu/lr_scheduler.py``,
a copy: that module imports no JAX, but the port imports nothing of the
JAX package).

Every schedule is stateless: ``sched(t)`` is a closed-form function of the
update count ``t`` alone, never of the query history (the MXNet reference
mutates ``base_lr`` while it scans steps).  Each class keeps the MXNet
constructor signature, so Optimizer and Trainer code passes
``lr_scheduler=`` objects unchanged.
"""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


def _warmup_value(t, *, steps, begin, end, mode):
    """lr during warmup, t in [0, steps)."""
    if mode == "linear":
        return begin + (end - begin) * (t / steps)
    if mode == "constant":
        return begin
    raise ValueError("unknown warmup_mode %r (want 'linear' or 'constant')"
                     % (mode,))


class LRScheduler:
    """Base class: handles the warmup ramp, delegates the rest to subclasses.

    Subclasses implement :meth:`_after_warmup`, a pure function of the
    update count, and never touch instance state from inside ``__call__``.
    """

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        if warmup_mode not in ("linear", "constant"):
            raise ValueError("unknown warmup_mode %r" % (warmup_mode,))
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        if num_update >= self.warmup_steps:
            raise ValueError("update %r is past the %r warmup steps"
                             % (num_update, self.warmup_steps))
        return _warmup_value(float(num_update), steps=float(self.warmup_steps),
                             begin=self.warmup_begin_lr,
                             end=self.warmup_final_lr, mode=self.warmup_mode)

    def _after_warmup(self, num_update):
        raise NotImplementedError

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        return self._after_warmup(num_update)


class FactorScheduler(LRScheduler):
    """lr = base_lr * factor^d, floored at stop_factor_lr.

    d counts the step boundaries strictly passed: a decay lands on update
    ``k*step + 1`` (k >= 1), matching the reference's scan loop.
    """

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise ValueError("step must be >= 1, got %r" % (step,))
        if factor > 1.0:
            raise ValueError("factor must be <= 1 so the lr decays, got %r"
                             % (factor,))
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def _after_warmup(self, num_update):
        decays = max(0, (num_update - 1) // self.step)
        return max(self.base_lr * self.factor ** decays, self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """lr = base_lr * factor^(number of milestones strictly passed)."""

    def __init__(self, step, factor=1, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list of milestones")
        if any(s < 1 for s in step):
            raise ValueError("every milestone must be >= 1: %r" % (step,))
        if any(b <= a for a, b in zip(step, step[1:])):
            raise ValueError("milestones must strictly increase: %r" % (step,))
        self.step = step
        self.factor = factor

    def _after_warmup(self, num_update):
        passed = sum(1 for milestone in self.step if num_update > milestone)
        return self.base_lr * self.factor ** passed


class PolyScheduler(LRScheduler):
    """Polynomial decay from base_lr to final_lr over max_update updates."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(max_update, int) or max_update < 1:
            raise ValueError("max_update must be a positive int, got %r"
                             % (max_update,))
        self.power = pwr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - warmup_steps

    def _after_warmup(self, num_update):
        t = min(num_update, self.max_update) - self.warmup_steps
        frac = 1.0 - t / float(self.max_steps)
        return self.final_lr + (self.base_lr - self.final_lr) * frac ** self.power


class CosineScheduler(LRScheduler):
    """Half-cosine decay from base_lr to final_lr over max_update updates."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(max_update, int) or max_update < 1:
            raise ValueError("max_update must be a positive int, got %r"
                             % (max_update,))
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - warmup_steps

    def _after_warmup(self, num_update):
        t = min(num_update, self.max_update) - self.warmup_steps
        cos_out = 0.5 * (1.0 + math.cos(math.pi * t / self.max_steps))
        return self.final_lr + (self.base_lr - self.final_lr) * cos_out
