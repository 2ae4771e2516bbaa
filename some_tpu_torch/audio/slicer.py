"""RMS-based silence slicer (host plane).

Copy of ``some_tpu/audio/slicer.py``. ``SilenceSlicer.slice`` runs the
envelope and the scan in C++ (``some_tpu_torch/native``) where that library
builds, else ``rms_envelope`` and ``scan_silence``, their plain versions
here, which give the same tags. ``_SliceScanner`` is the scan in
incremental form, which streaming drives. Defaults: -40 dB threshold, 5 s
min length, 300 ms min interval, max_sil_kept in ms.
"""
from __future__ import annotations

import numpy as np

from some_tpu_torch import native


def rms_envelope(y: np.ndarray, frame_length: int = 2048, hop_length: int = 512) -> np.ndarray:
    """Centered RMS per frame, matching librosa-style framing."""
    pad = frame_length // 2
    y = np.pad(y, (pad, pad), mode="constant")
    sq = np.concatenate(([0.0], np.cumsum(y.astype(np.float64) ** 2)))
    starts = np.arange(0, len(y) - frame_length + 1, hop_length)
    power = (sq[starts + frame_length] - sq[starts]) / frame_length
    return np.sqrt(power)


class _SliceScanner:
    """Incremental form of the silence-tag scan, a copy of
    ``some_tpu/audio/slicer.py::_SliceScanner`` (the Python twin of the
    native C++ scan).

    Every split decision at frame i reads only rms[0..i], so the exact
    offline algorithm runs frame by frame: ``feed`` returns the (start, end)
    silence tags decided so far, ``finish`` applies the trailing-silence
    rule. ``StreamingTranscriber`` (``inference/streaming.py``) drives the
    same scanner the offline slicer uses, so its chunk boundaries are the
    offline ones.
    """

    def __init__(self, threshold: float, min_interval: int, min_length: int,
                 max_sil_kept: int):
        self.threshold = threshold
        self.min_interval = min_interval
        self.min_length = min_length
        self.max_sil_kept = max_sil_kept
        self._rms: list = []
        self._rms_base = 0   # absolute frame index of _rms[0]
        self._silence_start = None
        self._clip_start = 0
        self._i = 0

    @property
    def n_frames(self) -> int:
        return self._i

    def _amin(self, a: int, b: int) -> int:
        """argmin of rms[a:b] as an absolute frame index."""
        seg = self._rms[a - self._rms_base:b - self._rms_base]
        return a + int(np.argmin(seg))

    def compact(self) -> None:
        """Drop RMS frames no future decision can read: every argmin window
        starts at the current silence stretch's start (or cannot start
        before the present frame when we are not inside silence). Keeps a
        live stream's scanner state O(current silence) instead of O(stream).
        Offline callers never need this — they feed once and discard."""
        keep_from = self._i if self._silence_start is None \
            else self._silence_start
        drop = keep_from - self._rms_base
        if drop >= 1 << 12:   # amortize list reshuffles
            del self._rms[:drop]
            self._rms_base = keep_from

    def _step(self, level: float):
        """Process one RMS frame; returns a (start, end) tag or None."""
        i = self._i
        self._rms.append(float(level))
        self._i = i + 1
        if level < self.threshold:
            if self._silence_start is None:
                self._silence_start = i
            return None
        if self._silence_start is None:
            return None
        # A silent stretch [silence_start, i) just ended at a loud frame.
        ss = self._silence_start
        msk = self.max_sil_kept
        is_leading_silence = ss == 0 and i > msk
        need_slice_middle = (i - ss >= self.min_interval
                             and i - self._clip_start >= self.min_length)
        if not is_leading_silence and not need_slice_middle:
            self._silence_start = None
            return None
        if i - ss <= msk:
            pos = self._amin(ss, i + 1)
            tag = (0, pos) if ss == 0 else (pos, pos)
            self._clip_start = pos
        elif i - ss <= msk * 2:
            pos = self._amin(i - msk, ss + msk + 1)
            pos_l = self._amin(ss, ss + msk + 1)
            pos_r = self._amin(i - msk, i + 1)
            if ss == 0:
                tag = (0, pos_r)
                self._clip_start = pos_r
            else:
                tag = (min(pos_l, pos), max(pos_r, pos))
                self._clip_start = max(pos_r, pos)
        else:
            pos_l = self._amin(ss, ss + msk + 1)
            pos_r = self._amin(i - msk, i + 1)
            tag = (0, pos_r) if ss == 0 else (pos_l, pos_r)
            self._clip_start = pos_r
        self._silence_start = None
        return tag

    def feed(self, levels) -> list:
        tags = []
        for level in levels:
            tag = self._step(level)
            if tag is not None:
                tags.append(tag)
        return tags

    def finish(self) -> list:
        total_frames = self._i
        ss = self._silence_start
        if ss is not None and total_frames - ss >= self.min_interval:
            silence_end = min(total_frames, ss + self.max_sil_kept)
            pos = self._amin(ss, silence_end + 1)
            return [(pos, total_frames + 1)]
        return []


def scan_silence(rms: np.ndarray, threshold: float, min_interval: int,
                 min_length: int, max_sil_kept: int) -> list:
    """Silence tags (start, end) in RMS frames over a whole envelope: the
    plain version of ``native.slicer_scan_native``."""
    scanner = _SliceScanner(threshold, min_interval, min_length, max_sil_kept)
    tags = scanner.feed(rms)
    tags.extend(scanner.finish())
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
        if native.native_available():
            rms = native.rms_envelope_native(samples, self.win_size, self.hop_size)
            tags = native.slicer_scan_native(rms, self.threshold, self.min_interval,
                                             self.min_length, self.max_sil_kept)
        else:
            rms = rms_envelope(samples, frame_length=self.win_size, hop_length=self.hop_size)
            tags = scan_silence(rms, self.threshold, self.min_interval, self.min_length,
                                self.max_sil_kept)
        return self.apply_tags(waveform, tags, rms.shape[0])

    def apply_tags(self, waveform: np.ndarray, tags: list, total_frames: int) -> list:
        """The chunks between the silence tags."""
        if not tags:
            return [{"offset": 0, "waveform": waveform}]
        chunks = []
        if tags[0][0] > 0:
            chunks.append(self._chunk(waveform, 0, tags[0][0]))
        for a, b in zip(tags[:-1], tags[1:]):
            chunks.append(self._chunk(waveform, a[1], b[0]))
        if tags[-1][1] < total_frames:
            chunks.append(self._chunk(waveform, tags[-1][1], total_frames))
        return chunks
