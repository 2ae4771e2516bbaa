"""Note-label normalization and frame alignment for binarization.

Copy of ``some_tpu/preprocessing/label_utils.py`` (the port imports nothing
of the JAX package). Host-plane equivalents of the reference's label utilities
(reference: utils/binarizer_utils.py:11-101, modules/commons/tts_modules.py):

* merge_slurs  — fold slurred notes into their parent when the pitch change
  stays within tolerance, duration-weighted averaging of the merged pitch.
* merge_rests  — collapse consecutive rest notes.
* durations_to_alignment — seconds -> frame counts via rounded cumsum
  (round(cumsum/dt + 0.5), diff) and a repeat-based frame->note index map
  (mel2ph format, 0 = padding): the LengthRegulator matmul trick is a GPU
  workaround; on host np.repeat is exact and O(T).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from some_tpu_torch.utils.note_names import midi_to_note, note_to_midi


def merge_slurs(note_seq: List[str], note_dur: List[float], note_slur: List[bool],
                tolerance: float | None = None) -> Tuple[List[str], List[float]]:
    """Merge slurs with similar pitch (reference: binarizer_utils.py:11-61)."""
    midis = [note_to_midi(n, round_midi=False) if n != "rest" else "rest"
             for n in note_seq]
    merged_midi = [midis[0]]
    merged_dur = [note_dur[0]]
    window_min = window_max = None

    def mergeable(midi):
        if tolerance is None or midi == "rest" or merged_midi[-1] == "rest":
            return merged_midi[-1] == midi
        return (abs(midi - merged_midi[-1]) <= tolerance
                and (window_min is None or abs(midi - window_min) <= tolerance)
                and (window_max is None or abs(midi - window_max) <= tolerance))

    for i in range(1, len(note_seq)):
        if note_slur[i] and mergeable(midis[i]):
            if window_min is None:
                window_min = min(midis[i], merged_midi[-1])
                window_max = max(midis[i], merged_midi[-1])
            else:
                window_min = min(window_min, midis[i])
                window_max = max(window_max, midis[i])
            if midis[i] != merged_midi[-1]:
                total = merged_dur[-1] + note_dur[i]
                merged_midi[-1] = (merged_midi[-1] * merged_dur[-1]
                                   + midis[i] * note_dur[i]) / total
            merged_dur[-1] += note_dur[i]
        else:
            merged_midi.append(midis[i])
            merged_dur.append(note_dur[i])
            window_min = window_max = None

    out_seq = [midi_to_note(m, cents=True, unicode=False) if m != "rest" else "rest"
               for m in merged_midi]
    return out_seq, merged_dur


def merge_rests(note_seq: List[str], note_dur: List[float]
                ) -> Tuple[List[str], List[float]]:
    """Collapse runs of rests (reference: binarizer_utils.py:64-83)."""
    out_seq: List[str] = []
    out_dur: List[float] = []
    for name, dur in zip(note_seq, note_dur):
        if name == "rest" and out_seq and out_seq[-1] == "rest":
            out_dur[-1] += dur
        else:
            out_seq.append(name)
            out_dur.append(dur)
    return out_seq, out_dur


def durations_to_frames(durs_sec: np.ndarray, timestep: float) -> np.ndarray:
    """Seconds -> integer frame counts via rounded cumulative boundaries
    (reference: me_binarizer.py:215-217 / binarizer_utils.py:86-88).
    Uses round-half-even to match torch.round."""
    acc = np.round(np.cumsum(durs_sec) / timestep + 0.5).astype(np.int64)
    return np.diff(acc, prepend=0)


def durations_to_alignment(durs_sec: np.ndarray, length: int, timestep: float
                           ) -> np.ndarray:
    """Seconds -> frame->note index map [length] (1-based, 0 = none).

    Equivalent to LengthRegulator + pad/crop (reference:
    binarizer_utils.py:86-94): frames beyond the total note span repeat the
    last note index.
    """
    frame_durs = durations_to_frames(np.asarray(durs_sec, dtype=np.float64), timestep)
    idx = np.repeat(np.arange(1, len(frame_durs) + 1), np.maximum(frame_durs, 0))
    if len(idx) < length:
        fill = idx[-1] if len(idx) else 0
        idx = np.concatenate([idx, np.full(length - len(idx), fill, dtype=idx.dtype)])
    return idx[:length].astype(np.int64)


def sinusoidal_smoothing(curve: np.ndarray, kernel_size: int) -> np.ndarray:
    """Half-sine FIR smoother for framewise curves (f0 etc.).

    Host-plane equivalent of the reference's ``SinusoidalSmoothingConv1d``
    (reference: utils/binarizer_utils.py:125-140 — defined but unused
    upstream; provided for parity): a 'same' cross-correlation with the
    fixed kernel sin(linspace(0, 1, K) * pi) normalized to sum 1, under
    replicate (edge) padding. The kernel is symmetric, so np.convolve's
    flip is a no-op; torch pads even kernels with the extra sample on the
    right, reproduced here.
    """
    curve = np.asarray(curve, dtype=np.float32)
    if curve.ndim != 1:
        raise ValueError(f"expected a 1-D curve, got shape {curve.shape}")
    if kernel_size < 1:
        raise ValueError("kernel_size must be >= 1")
    if kernel_size == 1 or len(curve) == 0:
        return curve.copy()
    kernel = np.sin(np.linspace(0, 1, kernel_size, dtype=np.float32) * np.pi)
    kernel /= kernel.sum()
    left = (kernel_size - 1) // 2
    right = kernel_size - 1 - left
    padded = np.concatenate([
        np.full(left, curve[0], dtype=np.float32), curve,
        np.full(right, curve[-1], dtype=np.float32)])
    return np.convolve(padded, kernel, mode="valid").astype(np.float32)
