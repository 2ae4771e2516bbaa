"""The SGDR family and NoamHoldAnnealing against the JAX package's, in f32.

Each schedule is built through ``build_schedule`` from the class path a
config names (``some_tpu/registry.py``'s aliases) and evaluated at steps
around the end of warmup, every restart boundary and the hold, on both
sides. Tolerance: |d| <= 1e-6 x |want| + 1e-7 x the curve's peak, a few f32
ulps (numpy's f32 cos, log2 and pow may differ from XLA's in the last bit),
and in units in the last place: equal, LSGDRLR within 1 ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from some_tpu.registry import resolve_class
from some_tpu_torch.training.schedules import build_schedule


def _around(points, lo=0):
    return sorted({max(lo, p + d) for p in points for d in (-2, -1, 0, 1, 2)})


# (scheduler args, steps) per case; a step is the 0-based update count and
# the schedules read n = step + 1
CASES = {
    "SGDRLR": ({"warmup_steps": 100, "min_lr": 1e-5, "T_0": 1500, "eta_max": 0.1,
                "eta_min": 0.0, "T_mul": 2},
               _around([0, 100, 1499, 4499, 10499, 22499, 46499]) + [777, 3000, 30000]),
    "SGDRLR_T_mul_1": ({"min_lr": 2e-2, "T_0": 40, "eta_max": 0.1, "eta_min": 1e-3,
                        "T_mul": 1}, _around([0, 39, 79, 119]) + [20, 60, 100]),
    "LSGDRLR": ({"T_0": 1500, "eta_min": 1e-4, "T_mult": 0.9999},
                _around([0, 749, 1499, 2249, 2999, 4499]) + [100000]),
    "V2LSGDRLR": ({"T_0": 9, "eta_max": 1.0}, _around([0, 6999, 7999, 21999, 36999, 51999])
                  + [12000, 30000, 300000]),
    "V3LSGDRLR": ({}, _around([0, 4999, 9999, 24999, 39999]) + [7000, 17000, 200000]),
    "NoamHoldAnnealing": ({"warmup_steps": 100, "hold_steps": 50, "decay_rate": 0.5,
                           "min_lr": 1e-6}, _around([0, 99, 149]) + [300, 5000, 10 ** 7]),
    "NoamHoldAnnealing_no_hold": ({"warmup_steps": 0, "decay_rate": 1.0, "min_lr": 0.0},
                                  _around([0, 1, 10])),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_matches_jax(case):
    name = case.split("_T_mul")[0].split("_no_hold")[0]
    args, steps = CASES[case]
    path = f"lr_scheduler.scheduler.{name}"
    ours = build_schedule({"scheduler_cls": path, **args}, 5e-4)
    cls = resolve_class(path)
    from some_tpu.registry import filter_kwargs

    theirs = cls(**filter_kwargs(dict(args, lr=5e-4), cls))
    want = np.asarray(theirs(jnp.asarray(steps, jnp.int32)), np.float32)
    assert want.dtype == np.float32
    got = np.array([ours(s) for s in steps], np.float64)
    assert all(isinstance(ours(s), float) for s in steps[:3])
    # the port's value is an f32 value carried in a Python float
    np.testing.assert_array_equal(got.astype(np.float32).astype(np.float64), got)
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * peak, err_msg=case)
    # in f32 units in the last place: equal, but LSGDRLR (an unscaled f32
    # cos plus a pow, numpy's against XLA's) at most 1 ulp
    ulps = np.abs(got.astype(np.float32).view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= (1 if name == "LSGDRLR" else 0), (case, ulps.max())


def test_schedule_names_cover_the_registry():
    """Every scheduler class path the JAX registry maps builds in the port."""
    from some_tpu.registry import REFERENCE_ALIASES

    paths = [p for p, target in REFERENCE_ALIASES.items() if "schedules" in target]
    assert len(paths) == 7
    for path in paths:
        sched = build_schedule({"scheduler_cls": path, "warmup_steps": 10, "t_total": 100},
                               1e-3)
        assert np.isfinite(sched(5))
    with pytest.raises(ValueError, match="unknown lr scheduler"):
        build_schedule({"scheduler_cls": "lr_scheduler.scheduler.NoSuch"}, 1e-3)
