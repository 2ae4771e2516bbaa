"""Host audio IO: WAV decode/encode, polyphase resampling (scipy), and the
decimation of the half-rate audio wire.

Copy of ``load_wav``, ``save_wav``, ``resample``, ``wire_decimation_taps``
and ``decimate_wire`` from ``some_tpu/audio/wavio.py``.
"""
from __future__ import annotations

import math
import pathlib

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

_PCM_SCALE = {np.dtype(np.int16): 32768.0, np.dtype(np.int32): 2147483648.0,
              np.dtype(np.uint8): 128.0}


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample along the last axis; float32 out."""
    if orig_sr == target_sr:
        return np.asarray(audio, dtype=np.float32)
    g = math.gcd(int(orig_sr), int(target_sr))
    out = resample_poly(np.asarray(audio, dtype=np.float64),
                        target_sr // g, orig_sr // g, axis=-1)
    return out.astype(np.float32)


def load_wav(path: pathlib.Path | str, sr: int | None = None,
             mono: bool = True) -> tuple[np.ndarray, int]:
    """Read a WAV file or file-like object -> (float32 waveform in [-1, 1],
    sample_rate)."""
    file_sr, data = wavfile.read(path if hasattr(path, "read") else str(path))
    if data.dtype in _PCM_SCALE:
        scale = _PCM_SCALE[data.dtype]
        if data.dtype == np.dtype(np.uint8):
            data = data.astype(np.float32) - 128.0
        data = np.asarray(data, dtype=np.float32) / scale
    else:
        data = np.asarray(data, dtype=np.float32)
    if mono and data.ndim > 1:
        data = data.mean(axis=1)
    if sr is not None and sr != file_sr:
        data = resample(data, file_sr, sr)
        file_sr = sr
    return np.ascontiguousarray(data, dtype=np.float32), file_sr


def save_wav(path: pathlib.Path | str, audio: np.ndarray, sr: int) -> None:
    """Write float32 [-1, 1] audio as 16-bit PCM."""
    pcm = np.clip(np.asarray(audio, dtype=np.float64), -1.0, 1.0)
    wavfile.write(str(path), sr, (pcm * 32767.0).astype(np.int16))


_WIRE_TAPS: dict = {}


def wire_decimation_taps(factor: int) -> np.ndarray:
    """Anti-alias FIR of the half-rate wire (``wire_sr``): odd length, so
    its group delay (N-1)/2 is a whole number of output samples; cutoff at
    the new Nyquist sr/(2 factor), above the mel filterbank's fmax; Kaiser
    beta 12 (about -115 dB sidelobes)."""
    taps = _WIRE_TAPS.get(factor)
    if taps is None:
        from scipy.signal import firwin
        taps = firwin(64 * factor + 1, 1.0 / factor, window=("kaiser", 12.0)).astype(np.float32)
        _WIRE_TAPS[factor] = taps
    return taps


def _decimate_fir(x: np.ndarray, taps: np.ndarray, factor: int) -> np.ndarray:
    """``resample_poly(x, 1, factor, window=taps)`` for odd gain-1 taps, in
    the JAX package's native arithmetic (``decimate_fir`` of
    some_tpu/native/audio_frontend.cpp): out[i] = sum_k taps[k] * xz[factor
    i + k - half], summed phase by phase and tap by tap in f32, each step a
    fused multiply-add (the native build contracts it). An f32 FMA is one
    rounding of an exact product plus the sum; here the product is exact in
    f64 and the f64 sum rounds to f32."""
    n, n_taps = len(x), len(taps)
    half = n_taps // 2
    n_out = -(-n // factor)
    per_phase = -(-n_taps // factor)
    width = n_out + per_phase + 1
    out = np.zeros(n_out, np.float32)
    for b in range(factor):
        # phase b: xz[factor m + b - half] for m in [0, width), zero outside x
        m = np.arange(width)
        j = factor * m + b - half
        ok = (j >= 0) & (j < n)
        phase = np.zeros(width, np.float64)
        phase[ok] = x[j[ok]]
        for a in range(per_phase):
            k = factor * a + b
            if k >= n_taps:
                break
            t = float(taps[k])
            if t == 0.0:
                continue
            out = (out + t * phase[a:a + n_out]).astype(np.float32)
    return out


def decimate_wire(audio: np.ndarray, factor: int) -> np.ndarray:
    """Decimate float32 audio by an integer factor for the transfer wire,
    gain 1 in the passband. The STFT magnitude of the shorter analysis
    window is compensated in the device mel (``LogMelSpec(mag_scale=)``),
    not here, so wire encoding and silence thresholds see true amplitudes.
    A 1-D waveform takes the JAX package's native FIR arithmetic, anything
    else its scipy path, as the JAX function does."""
    if factor == 1:
        return np.asarray(audio, dtype=np.float32)
    taps = wire_decimation_taps(factor)
    if np.ndim(audio) == 1:
        return _decimate_fir(np.asarray(audio, np.float32), taps, factor)
    return resample_poly(np.asarray(audio, dtype=np.float32), 1, factor,
                         axis=-1, window=taps).astype(np.float32)
