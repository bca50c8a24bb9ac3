"""LR schedules (counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``:
the reference's ``LRRangeTest``, ``OneCycle``, ``WarmupLR`` and
``WarmupDecayLR``).

Each schedule is a pure ``step -> lr`` function of a host step count
returning a Python float: the engine evaluates it on the host at every
optimizer step and hands the number to the update, so no device value
is read. :class:`LRScheduler` wraps one in the reference's
``step()``/``get_lr()``/``state_dict()`` surface. The CLI tuning-argument
helpers of the JAX module come with a later slice.
"""

import math
from typing import Callable

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]

WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"


def _clip(x, lo, hi):
    return min(max(x, lo), hi)


def lr_range_test_fn(lr_range_test_min_lr=1e-3,
                     lr_range_test_step_size=2000,
                     lr_range_test_step_rate=1.0,
                     lr_range_test_staircase=False,
                     **_) -> Callable:
    """Increasing sweep for LR range tests (reference ``LRRangeTest``)."""

    def schedule(step):
        interval = step / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval
                                       * lr_range_test_step_rate)

    return schedule


def one_cycle_fn(cycle_min_lr,
                 cycle_max_lr,
                 cycle_first_step_size=2000,
                 cycle_second_step_size=None,
                 cycle_first_stair_count=0,
                 cycle_second_stair_count=None,
                 decay_step_size=0,
                 decay_lr_rate=0.0,
                 **_) -> Callable:
    """Triangular one-cycle policy (reference ``OneCycle``; momentum
    cycling is not applied — betas stay config-driven). A positive stair
    count quantizes its phase into that many lr levels."""
    second = (cycle_second_step_size if cycle_second_step_size is not None
              else cycle_first_step_size)
    stairs2 = (cycle_second_stair_count if cycle_second_stair_count
               is not None else cycle_first_stair_count)
    total = cycle_first_step_size + second

    def _quantize(frac, count):
        if count and count > 0:
            return math.floor(frac * count) / count
        return frac

    def schedule(step):
        up = _quantize(min(step / cycle_first_step_size, 1.0),
                       cycle_first_stair_count)
        down = _quantize(_clip((step - cycle_first_step_size) / second,
                               0.0, 1.0), stairs2)
        lr = cycle_min_lr + (cycle_max_lr - cycle_min_lr) * (up - down)
        if decay_step_size > 0:
            decay_steps = max(step - total, 0.0) / decay_step_size
            lr = lr / (1.0 + decay_lr_rate * decay_steps)
        return max(lr, 0.0)

    return schedule


def warmup_lr_fn(warmup_min_lr=0.0,
                 warmup_max_lr=0.001,
                 warmup_num_steps=1000,
                 warmup_type=WARMUP_LOG_RATE,
                 **_) -> Callable:
    """Warmup then constant (reference ``WarmupLR``): the log warmup is
    ``log(step + 1) / log(N + 1)``, as the reference computes it."""
    warmup_num_steps = max(2, warmup_num_steps)

    def schedule(step):
        frac = _clip(step / warmup_num_steps, 0.0, 1.0)
        if warmup_type == WARMUP_LOG_RATE:
            frac = (math.log1p(min(step, warmup_num_steps))
                    / math.log(warmup_num_steps + 1))
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * frac

    return schedule


def warmup_decay_lr_fn(total_num_steps,
                       warmup_min_lr=0.0,
                       warmup_max_lr=0.001,
                       warmup_num_steps=1000,
                       warmup_type=WARMUP_LOG_RATE,
                       **_) -> Callable:
    """Warmup then linear decay to zero (reference ``WarmupDecayLR``)."""
    warmup = warmup_lr_fn(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                          warmup_type)
    warmup_num_steps_ = max(2, warmup_num_steps)

    def schedule(step):
        if step <= warmup_num_steps_:
            return warmup(step)
        decay_frac = _clip((total_num_steps - step)
                           / max(1, total_num_steps - warmup_num_steps_),
                           0.0, 1.0)
        return warmup_max_lr * decay_frac

    return schedule


_SCHEDULE_FNS = {
    LR_RANGE_TEST: lr_range_test_fn,
    ONE_CYCLE: one_cycle_fn,
    WARMUP_LR: warmup_lr_fn,
    WARMUP_DECAY_LR: warmup_decay_lr_fn,
}


def get_lr_schedule_fn(name: str, params: dict) -> Callable:
    if name not in _SCHEDULE_FNS:
        raise ValueError(f"Unknown scheduler {name!r}; valid: "
                         f"{VALID_LR_SCHEDULES}")
    return _SCHEDULE_FNS[name](**params)


class LRScheduler:
    """Stateful wrapper with the reference scheduler surface."""

    def __init__(self, schedule_fn: Callable, last_batch_iteration: int = -1):
        self.schedule_fn = schedule_fn
        self.last_batch_iteration = last_batch_iteration

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self):
        return [float(self.schedule_fn(max(self.last_batch_iteration, 0)))]

    def get_last_lr(self):
        return self.get_lr()

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


# class-style constructors for API parity
def LRRangeTest(optimizer=None, **params):
    return LRScheduler(lr_range_test_fn(**params))


def OneCycle(optimizer=None, **params):
    return LRScheduler(one_cycle_fn(**params))


def WarmupLR(optimizer=None, **params):
    return LRScheduler(warmup_lr_fn(**params))


def WarmupDecayLR(optimizer=None, **params):
    return LRScheduler(warmup_decay_lr_fn(**params))
