"""Learning-rate schedules: plain functions of the 0-based update count.

Counterpart of ``some_tpu/training/schedules.py``. Each computes in float32
as the JAX package does, so the values match bit for bit; the step is the
number of updates applied before this one. ``build_schedule`` resolves the
config's ``scheduler_cls`` (the reference class paths the configs name).
"""
from __future__ import annotations

import inspect

import numpy as np

_F32 = np.float32


class WarmupLR:
    """lr = base * ws^0.5 * min(n^-0.5, n * ws^-1.5), n = step + 1, floored
    at min_lr once n > warmup_steps."""

    def __init__(self, lr: float, warmup_steps: int = 5000, min_lr: float = 2e-5):
        self.base_lr = float(lr)
        self.warmup_steps = warmup_steps
        self.min_lr = float(min_lr)

    def __call__(self, step) -> float:
        n = _F32(step) + _F32(1.0)
        if self.warmup_steps == 0:
            return float(max(_F32(self.base_lr) * n ** _F32(-0.5), _F32(self.min_lr)))
        ws = float(self.warmup_steps)
        lr = _F32(self.base_lr * ws ** 0.5) * min(n ** _F32(-0.5), n * _F32(ws ** -1.5))
        return float(_F32(self.min_lr) if (lr < _F32(self.min_lr) and n > _F32(ws)) else lr)


class WarmupCosineSchedule:
    """Linear warmup, then a cosine decay floored at eta_min."""

    def __init__(self, lr: float, warmup_steps: int, t_total: int,
                 eta_min: float = 0.0, cycles: float = 0.5):
        self.base_lr = float(lr)
        self.warmup_steps = warmup_steps
        self.t_total = t_total
        self.eta_min = eta_min
        self.cycles = cycles

    def __call__(self, step) -> float:
        step = _F32(step)
        warm = step / _F32(max(1.0, self.warmup_steps))
        progress = (step - _F32(self.warmup_steps)) / _F32(max(1, self.t_total - self.warmup_steps))
        cos = max(_F32(self.eta_min), _F32(0.5) * (_F32(1.0) + np.cos(
            _F32(np.pi) * _F32(self.cycles * 2.0) * progress, dtype=_F32)))
        return float(_F32(self.base_lr) * (warm if step < _F32(self.warmup_steps) else cos))


SCHEDULES = {
    "lr_scheduler.scheduler.WarmupLR": WarmupLR,
    "utils.training_utils.WarmupCosineSchedule": WarmupCosineSchedule,
}


def build_schedule(scheduler_args: dict, base_lr: float):
    """Config dict -> schedule callable; keys the class does not take are
    dropped, as the JAX registry's filter_kwargs does; class paths the port
    lacks raise."""
    name = scheduler_args["scheduler_cls"]
    if name not in SCHEDULES:
        raise NotImplementedError(f"lr scheduler {name!r} is still to port (have "
                                  f"{sorted(SCHEDULES)}): see ROADMAP.md")
    cls = SCHEDULES[name]
    kwargs = {k: v for k, v in scheduler_args.items() if k != "scheduler_cls"}
    kwargs["lr"] = base_lr
    accepted = inspect.signature(cls).parameters
    return cls(**{k: v for k, v in kwargs.items() if k in accepted})
