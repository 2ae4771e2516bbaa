"""Mel filterbank and Hann window, host side (numpy).

Copy of ``mel_filterbank`` and ``hann_window`` from ``some_tpu/audio/mel.py``
(the port imports nothing of the JAX package). The device log-mel that uses
them is ``some_tpu_torch/ops/melspec.py``.
"""
from __future__ import annotations

import numpy as np


def _hz_to_mel_htk(freq):
    return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float | None,
                   htk: bool = True, norm: str = "slaney") -> np.ndarray:
    """Triangular mel filterbank [n_mels, n_fft//2+1].

    Matches librosa.filters.mel(htk=True, norm='slaney') bit-for-bit in
    float64 then cast to float32 — the exact basis the reference registers as
    a buffer (reference: modules/rmvpe/spec.py:22-29).
    """
    if fmax is None:
        fmax = float(sr) / 2
    if not htk:
        raise NotImplementedError("only the HTK mel scale is used by this pipeline")

    n_bins = n_fft // 2 + 1
    fftfreqs = np.linspace(0, float(sr) / 2, n_bins, dtype=np.float64)
    mel_pts = np.linspace(_hz_to_mel_htk(fmin), _hz_to_mel_htk(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_htk(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm[:, None]
    elif norm is not None:
        raise ValueError(f"unsupported norm: {norm}")
    return weights.astype(np.float32)


def hann_window(n: int, dtype=np.float64) -> np.ndarray:
    """Periodic Hann window (torch.hann_window semantics)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n, dtype=dtype) / n)).astype(dtype)
