"""Host audio IO: WAV decode/encode and polyphase resampling (scipy).

Copy of ``load_wav``, ``save_wav`` and ``resample`` from
``some_tpu/audio/wavio.py``.
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
