"""RMS-based silence slicer (host plane), Python scan.

Copy of ``some_tpu/audio/slicer.py`` without its native C++ scan, which the
JAX package's tests hold equal to this Python scan (tests/test_native.py);
the C++ scan is a later slice of the port. Defaults: -40 dB threshold, 5 s
min length, 300 ms min interval, max_sil_kept in ms.
"""
from __future__ import annotations

import numpy as np


def rms_envelope(y: np.ndarray, frame_length: int = 2048, hop_length: int = 512) -> np.ndarray:
    """Centered RMS per frame, matching librosa-style framing."""
    pad = frame_length // 2
    y = np.pad(y, (pad, pad), mode="constant")
    sq = np.concatenate(([0.0], np.cumsum(y.astype(np.float64) ** 2)))
    starts = np.arange(0, len(y) - frame_length + 1, hop_length)
    power = (sq[starts + frame_length] - sq[starts]) / frame_length
    return np.sqrt(power)


def scan_silence(rms: np.ndarray, threshold: float, min_interval: int,
                 min_length: int, max_sil_kept: int) -> list:
    """Silence tags (start, end) in RMS frames, the scan of
    ``some_tpu/audio/slicer.py::_SliceScanner`` run over a whole envelope."""
    tags = []
    silence_start = None
    clip_start = 0
    msk = max_sil_kept

    def amin(a: int, b: int) -> int:
        return a + int(np.argmin(rms[a:b]))

    for i, level in enumerate(rms):
        if level < threshold:
            if silence_start is None:
                silence_start = i
            continue
        if silence_start is None:
            continue
        ss = silence_start
        is_leading_silence = ss == 0 and i > msk
        need_slice_middle = i - ss >= min_interval and i - clip_start >= min_length
        if not is_leading_silence and not need_slice_middle:
            silence_start = None
            continue
        if i - ss <= msk:
            pos = amin(ss, i + 1)
            tags.append((0, pos) if ss == 0 else (pos, pos))
            clip_start = pos
        elif i - ss <= msk * 2:
            pos = amin(i - msk, ss + msk + 1)
            pos_l = amin(ss, ss + msk + 1)
            pos_r = amin(i - msk, i + 1)
            if ss == 0:
                tags.append((0, pos_r))
                clip_start = pos_r
            else:
                tags.append((min(pos_l, pos), max(pos_r, pos)))
                clip_start = max(pos_r, pos)
        else:
            pos_l = amin(ss, ss + msk + 1)
            pos_r = amin(i - msk, i + 1)
            tags.append((0, pos_r) if ss == 0 else (pos_l, pos_r))
            clip_start = pos_r
        silence_start = None

    total_frames = len(rms)
    if silence_start is not None and total_frames - silence_start >= min_interval:
        silence_end = min(total_frames, silence_start + msk)
        pos = amin(silence_start, silence_end + 1)
        tags.append((pos, total_frames + 1))
    return tags


class SilenceSlicer:
    def __init__(self, sr: int, threshold: float = -40.0, min_length: int = 5000,
                 min_interval: int = 300, hop_size: int = 20, max_sil_kept: int = 5000):
        if not min_length >= min_interval >= hop_size:
            raise ValueError("min_length >= min_interval >= hop_size required")
        if not max_sil_kept >= hop_size:
            raise ValueError("max_sil_kept >= hop_size required")
        min_interval_samples = sr * min_interval / 1000
        self.sr = sr
        self.threshold = 10 ** (threshold / 20.0)
        self.hop_size = round(sr * hop_size / 1000)
        self.win_size = min(round(min_interval_samples), 4 * self.hop_size)
        self.min_length = round(sr * min_length / 1000 / self.hop_size)
        self.min_interval = round(min_interval_samples / self.hop_size)
        self.max_sil_kept = round(sr * max_sil_kept / 1000 / self.hop_size)

    def _chunk(self, waveform: np.ndarray, begin: int, end: int) -> dict:
        start_sample = begin * self.hop_size
        end_sample = min(waveform.shape[-1], end * self.hop_size)
        if waveform.ndim > 1:
            piece = waveform[:, start_sample:end_sample]
        else:
            piece = waveform[start_sample:end_sample]
        return {"offset": start_sample / self.sr, "waveform": piece}

    def slice(self, waveform: np.ndarray) -> list:
        samples = waveform.mean(axis=0) if waveform.ndim > 1 else waveform
        if (samples.shape[0] + self.hop_size - 1) // self.hop_size <= self.min_length:
            return [{"offset": 0, "waveform": waveform}]
        rms = rms_envelope(samples, frame_length=self.win_size, hop_length=self.hop_size)
        tags = scan_silence(rms, self.threshold, self.min_interval,
                            self.min_length, self.max_sil_kept)
        if not tags:
            return [{"offset": 0, "waveform": waveform}]
        chunks = []
        if tags[0][0] > 0:
            chunks.append(self._chunk(waveform, 0, tags[0][0]))
        for a, b in zip(tags[:-1], tags[1:]):
            chunks.append(self._chunk(waveform, a[1], b[0]))
        if tags[-1][1] < rms.shape[0]:
            chunks.append(self._chunk(waveform, tags[-1][1], rms.shape[0]))
        return chunks
