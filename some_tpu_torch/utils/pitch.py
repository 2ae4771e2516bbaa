"""F0 curve helpers: unvoiced interpolation and timestep resampling.

Copy of ``some_tpu/utils/pitch.py`` (the port imports nothing of the JAX
package). Numerically equivalent to the reference pitch utilities
(reference: utils/pitch_utils.py:24-61): interpolation over unvoiced frames
happens in log2 domain, and curve resampling is linear interpolation onto a
new timestep grid followed by pad/crop to a target length.
"""
from __future__ import annotations

import numpy as np


F0_BIN = 256
F0_MAX = 1100.0
F0_MIN = 50.0
_F0_MEL_MIN = 1127 * np.log(1 + F0_MIN / 700)
_F0_MEL_MAX = 1127 * np.log(1 + F0_MAX / 700)


def f0_to_coarse(f0: np.ndarray) -> np.ndarray:
    """Quantize f0 (Hz) to 256 mel-spaced bins (reference: pitch_utils.py:11-21;
    unused by the shipped pipeline, kept for API parity)."""
    f0_mel = 1127 * np.log(1 + np.asarray(f0, dtype=np.float64) / 700)
    scaled = (f0_mel - _F0_MEL_MIN) * (F0_BIN - 2) / (_F0_MEL_MAX - _F0_MEL_MIN) + 1
    f0_mel = np.where(f0_mel > 0, scaled, f0_mel)
    f0_mel = np.clip(f0_mel, 1, F0_BIN - 1)
    return np.rint(f0_mel).astype(np.int64)


def norm_f0(f0: np.ndarray, uv: np.ndarray | None = None) -> np.ndarray:
    if uv is None:
        uv = f0 == 0
    f0 = np.log2(f0 + uv)  # +uv avoids log(0) on unvoiced frames
    f0[uv] = -np.inf
    return f0


def denorm_f0(f0: np.ndarray, uv: np.ndarray | None) -> np.ndarray:
    f0 = 2 ** f0
    if uv is not None:
        f0[uv > 0] = 0
    return f0


def interp_f0(f0: np.ndarray, uv: np.ndarray | None = None):
    """Linearly interpolate (in log2 space) across unvoiced regions."""
    if uv is None:
        uv = f0 == 0
    f0 = norm_f0(f0, uv)
    if uv.any() and not uv.all():
        f0[uv] = np.interp(np.where(uv)[0], np.where(~uv)[0], f0[~uv])
    return denorm_f0(f0, uv=None), uv


def resample_align_curve(points: np.ndarray, original_timestep: float,
                         target_timestep: float, align_length: int) -> np.ndarray:
    """Resample a curve to a new timestep and pad/crop to ``align_length``."""
    t_max = (len(points) - 1) * original_timestep
    curve_interp = np.interp(
        np.arange(0, t_max, target_timestep),
        original_timestep * np.arange(len(points)),
        points,
    ).astype(points.dtype)
    delta_l = align_length - len(curve_interp)
    if delta_l < 0:
        curve_interp = curve_interp[:align_length]
    elif delta_l > 0:
        curve_interp = np.concatenate(
            (curve_interp, np.full(delta_l, fill_value=curve_interp[-1])), axis=0
        )
    return curve_interp
