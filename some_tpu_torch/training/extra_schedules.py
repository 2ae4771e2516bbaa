"""The cosine-restart schedules and NoamHoldAnnealing.

Counterpart of ``some_tpu/training/extra_schedules.py``: plain functions of
the 0-based update count, computed in float32 as the JAX package computes
them (every constant is cast to float32 before it meets the step, so the
result does not depend on numpy's scalar promotion rules). Transcendentals
(cos, log2, pow) are numpy's float32 ones, which may differ from XLA's in
the last bit.
"""
from __future__ import annotations

import numpy as np

_F32 = np.float32
_PI = _F32(np.pi)


def _step_num(step) -> np.float32:
    return _F32(step) + _F32(1.0)


class SGDRLR:
    """Cosine annealing with warm restarts (SGDR), floored at ``min_lr``;
    with ``T_mul == 2`` each period doubles."""

    def __init__(self, lr: float, warmup_steps: int = 25000, min_lr: float = 1e-5,
                 T_0: int = 1500, eta_max: float = 0.1, eta_min: float = 0.0,
                 T_mul: int = 2):
        self.base_lr = float(lr)
        self.warmup_steps = warmup_steps
        self.min_lr = float(min_lr)
        self.T_0 = T_0
        self.eta_max = eta_max
        self.eta_min = eta_min
        self.T_mul = T_mul

    def __call__(self, step) -> float:
        n = _step_num(step)
        T_0 = _F32(self.T_0)
        if self.T_mul == 2:
            i = np.floor(np.log2(n / T_0 + _F32(1.0)))
            t_cur = n - T_0 * (_F32(2.0) ** i - _F32(1.0))
            t_i = T_0 * _F32(2.0) ** i
        else:
            t_cur = np.mod(n, T_0)
            t_i = T_0
        half_span = _F32(0.5 * (self.eta_max - self.eta_min))
        lr = _F32(self.eta_min) + half_span * (_F32(1.0) + np.cos(_PI * t_cur / t_i))
        return float(max(lr, _F32(self.min_lr)))


class LSGDRLR:
    """The reference's 'L' variant, ``eta_min * T_mult**n + cos(pi n / T_0)``
    as it stands upstream (an unscaled cosine; warmup_steps and min_lr are
    taken and unused, as there)."""

    def __init__(self, lr: float, warmup_steps: int = 25000, min_lr: float = 1e-5,
                 T_0: int = 1500, eta_max: float = 0.1, eta_min: float = 0.0,
                 T_mul: int = 2, T_mult: float = 0.9999):
        self.base_lr = float(lr)
        self.warmup_steps = warmup_steps
        self.min_lr = float(min_lr)
        self.T_0 = T_0
        self.eta_max = eta_max
        self.eta_min = eta_min
        self.T_mul = T_mul
        self.T_mult = T_mult

    def __call__(self, step) -> float:
        n = _step_num(step)
        return float(_F32(self.eta_min) * _F32(self.T_mult) ** n
                     + np.cos(_PI * n / _F32(self.T_0)))


class V2LSGDRLR:
    """Linear warmup to eta_max over ws steps, then cosine restarts of period
    T_0 whose amplitude decays by tmctx a cycle. The constants are the
    reference's ``ctxadjust_lr`` defaults; the constructor's are ignored,
    as there."""

    CTX = dict(T_0=15000.0, eta_min=0.0000001, eta_max=0.00006, tmctx=0.99, ws=8000.0)

    def __init__(self, lr: float, **_ignored):
        self.base_lr = float(lr)

    def _cycle_lr(self, n, eta_min_scaled: bool) -> float:
        c = {k: _F32(v) for k, v in self.CTX.items()}
        t_cur = np.mod(n + c["ws"], c["T_0"])
        t_curx = np.floor((n + c["ws"]) / c["T_0"])
        decay = c["tmctx"] ** t_curx
        eta_min = c["eta_min"] * decay if eta_min_scaled else c["eta_min"]
        lr = eta_min + _F32(0.5) * (c["eta_max"] * decay - c["eta_min"] * decay) * (
            _F32(1.0) + np.cos(_PI * t_cur / c["T_0"]))
        warm = n * _F32(self.CTX["eta_max"] / self.CTX["ws"])  # the ratio in f64, as JAX
        return float(warm if c["ws"] > n else lr)

    def __call__(self, step) -> float:
        return self._cycle_lr(_step_num(step), eta_min_scaled=False)


class V3LSGDRLR(V2LSGDRLR):
    """v2 with other constants, and a cosine floor that decays too."""

    CTX = dict(T_0=15000.0, eta_min=0.00006, eta_max=0.00009, tmctx=0.98, ws=5000.0)

    def __call__(self, step) -> float:
        return self._cycle_lr(_step_num(step), eta_min_scaled=True)


class NoamHoldAnnealing:
    """Linear warmup, a hold at the base lr, then inverse-power decay,
    floored at ``min_lr``."""

    def __init__(self, lr: float, warmup_steps: int, hold_steps: int = 0,
                 decay_rate: float = 0.5, min_lr: float = 0.0):
        self.base_lr = float(lr)
        self.warmup_steps = warmup_steps
        self.hold_steps = hold_steps
        self.decay_rate = decay_rate
        self.min_lr = float(min_lr)

    def __call__(self, step) -> float:
        n = _step_num(step)
        warm = self.warmup_steps
        hold = warm + self.hold_steps
        base = _F32(self.base_lr)
        if n <= _F32(warm):
            lr = base * n / _F32(max(warm, 1))
        elif n <= _F32(hold):
            lr = base
        else:
            lr = base * max(n - _F32(hold) + _F32(1.0), _F32(1.0)) ** _F32(-self.decay_rate)
        return float(max(lr, _F32(self.min_lr)))
