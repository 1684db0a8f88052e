"""LR schedules.

Port of ``deepspeed_tpu/runtime/lr_schedules.py`` (analogue of the reference
``deepspeed/runtime/lr_schedules.py``: ``LRRangeTest`` :258, ``OneCycle``
:361, ``WarmupLR`` :626, ``WarmupDecayLR`` :715, plus ``WarmupCosineLR``).
Same values, as plain Python math on the host: the port's engine keeps the
applied-step count on the host and hands the optimizer a Python float. Two
call styles, as in the JAX package:

- **functional**: every schedule is ``__call__(step) -> lr``;
- **stateful facade**: ``step()`` / ``get_lr()`` / ``state_dict()`` /
  ``load_state_dict()`` for reference API parity.
"""

import math

VALID_LR_SCHEDULES = ["LRRangeTest", "OneCycle", "WarmupLR", "WarmupDecayLR", "WarmupCosineLR"]

WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"


def _clip(x, lo, hi):
    return min(max(x, lo), hi)


class _LRSchedule:
    """Base: stateful facade over a pure ``step -> lr`` function."""

    def __init__(self, optimizer=None, last_batch_iteration=-1):
        self.optimizer = optimizer
        self.last_batch_iteration = last_batch_iteration

    def __call__(self, step):
        raise NotImplementedError

    def get_lr(self):
        return [float(self(max(self.last_batch_iteration, 0)))]

    def get_last_lr(self):
        if getattr(self, "_last_lr", None) is None:
            raise RuntimeError("need to call step() first")
        return self._last_lr

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        self._last_lr = [float(self(last_batch_iteration))]
        if self.optimizer is not None and hasattr(self.optimizer, "set_lr"):
            self.optimizer.set_lr(self._last_lr[0])

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class LRRangeTest(_LRSchedule):
    """LR range test (reference :258): linear or continuous staircase ramp."""

    def __init__(self,
                 optimizer=None,
                 lr_range_test_min_lr=1e-3,
                 lr_range_test_step_size=2000,
                 lr_range_test_step_rate=1.0,
                 lr_range_test_staircase=False,
                 last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase

    def __call__(self, step):
        step = float(step)
        interval = math.floor(step / self.step_size) if self.staircase else step / self.step_size
        return self.min_lr * (1 + interval * self.step_rate)


class OneCycle(_LRSchedule):
    """1-cycle policy (reference :361): cycle lr up/down then decay."""

    def __init__(self,
                 optimizer=None,
                 cycle_min_lr=0.0,
                 cycle_max_lr=1e-3,
                 decay_lr_rate=0.0,
                 cycle_first_step_size=2000,
                 cycle_second_step_size=None,
                 cycle_first_stair_count=0,
                 cycle_second_stair_count=None,
                 decay_step_size=0,
                 cycle_momentum=True,
                 cycle_min_mom=0.85,
                 cycle_max_mom=0.99,
                 decay_mom_rate=0.0,
                 last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first_size = cycle_first_step_size
        self.second_size = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
        self.decay_step_size = decay_step_size
        self.total_size = self.first_size + self.second_size
        self.cycle_momentum = cycle_momentum
        self.cycle_min_mom = cycle_min_mom
        self.cycle_max_mom = cycle_max_mom
        self.decay_mom_rate = decay_mom_rate

    def __call__(self, step):
        step = float(step)
        if step <= self.total_size:
            return self.cycle_min_lr + (self.cycle_max_lr - self.cycle_min_lr) * self._cycle_scale(step)
        decay_steps = (step - self.total_size) / self.decay_step_size if self.decay_step_size > 0 else 0.0
        return self.cycle_min_lr / (1.0 + decay_steps * self.decay_lr_rate)

    def _cycle_scale(self, step):
        if step <= self.first_size:
            return _clip(step / self.first_size, 0.0, 1.0)
        return 1.0 - _clip((step - self.first_size) / self.second_size, 0.0, 1.0)

    def get_mom(self, step):
        return self.cycle_max_mom - (self.cycle_max_mom - self.cycle_min_mom) * self._cycle_scale(float(step))


class WarmupLR(_LRSchedule):
    """Warmup then hold (reference :626)."""

    def __init__(self,
                 optimizer=None,
                 warmup_min_lr=0.0,
                 warmup_max_lr=0.001,
                 warmup_num_steps=1000,
                 warmup_type=WARMUP_LOG_RATE,
                 last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        self.warmup_min_lr = warmup_min_lr
        self.warmup_max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)

    def _warmup_gamma(self, step):
        if self.warmup_type == WARMUP_LOG_RATE:
            return self.inverse_log_warm_up * math.log(max(step, 1.0))
        return step / self.warmup_num_steps

    def __call__(self, step):
        step = float(step)
        if step >= self.warmup_num_steps:
            return self._post_warmup_lr(step)
        gamma = _clip(self._warmup_gamma(step), 0.0, 1.0)
        return self.warmup_min_lr + (self.warmup_max_lr - self.warmup_min_lr) * gamma

    def _post_warmup_lr(self, step):
        return float(self.warmup_max_lr)


class WarmupDecayLR(WarmupLR):
    """Warmup then linear decay to zero over total_num_steps (reference :715)."""

    def __init__(self,
                 optimizer=None,
                 total_num_steps=10000,
                 warmup_min_lr=0.0,
                 warmup_max_lr=0.001,
                 warmup_num_steps=1000,
                 warmup_type=WARMUP_LOG_RATE,
                 last_batch_iteration=-1):
        self.total_num_steps = total_num_steps
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type,
                         last_batch_iteration)

    def _post_warmup_lr(self, step):
        frac = (self.total_num_steps - step) / max(1.0, self.total_num_steps - self.warmup_num_steps)
        return self.warmup_max_lr * _clip(frac, 0.0, 1.0)


class WarmupCosineLR(WarmupLR):
    """Warmup then cosine decay (upstream post-0.9 schedule)."""

    def __init__(self,
                 optimizer=None,
                 total_num_steps=10000,
                 warmup_min_ratio=0.0,
                 warmup_num_steps=1000,
                 cos_min_ratio=0.0001,
                 warmup_max_lr=0.001,
                 warmup_type=WARMUP_LOG_RATE,
                 last_batch_iteration=-1):
        self.total_num_steps = total_num_steps
        self.cos_min_ratio = cos_min_ratio
        super().__init__(optimizer, warmup_min_ratio * warmup_max_lr, warmup_max_lr, warmup_num_steps,
                         warmup_type, last_batch_iteration)

    def _post_warmup_lr(self, step):
        frac = _clip((step - self.warmup_num_steps) / max(1.0, self.total_num_steps - self.warmup_num_steps),
                     0.0, 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * frac))
        ratio = self.cos_min_ratio + (1 - self.cos_min_ratio) * cos
        return self.warmup_max_lr * ratio


SCHEDULE_CLASSES = {
    "LRRangeTest": LRRangeTest,
    "OneCycle": OneCycle,
    "WarmupLR": WarmupLR,
    "WarmupDecayLR": WarmupDecayLR,
    "WarmupCosineLR": WarmupCosineLR,
}


def get_lr_schedule(name, params, optimizer=None):
    if name not in SCHEDULE_CLASSES:
        raise ValueError(f"Unknown lr schedule {name}; valid: {VALID_LR_SCHEDULES}")
    return SCHEDULE_CLASSES[name](optimizer=optimizer, **params)
