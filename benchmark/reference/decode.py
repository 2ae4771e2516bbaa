"""Plain reference of SOME's note decoding (frames -> notes), in numpy float64.

* pitch per frame: the probability-weighted mean of the bin values within
  +-3 deviations of the most probable bin; a frame whose largest
  probability is under ``rest_threshold`` is unvoiced;
* notes: a new note starts wherever the rounded running sum of the boundary
  probabilities rises (the first frame starts the first note);
* a note is a rest unless at least half of its frames are voiced; its pitch
  is the mean of its voiced frames' pitches that lie within half a semitone
  of the most common rounded pitch among them.
"""
from __future__ import annotations

import numpy as np


def frame_pitch(probs: np.ndarray, vmin: float, vmax: float, deviation: float,
                threshold: float):
    """probs [T, bins] -> (pitch [T], voiced [T])."""
    bins = probs.shape[1]
    interval = (vmax - vmin) / (bins - 1)
    width = int(3 * deviation / interval)
    values = np.arange(bins) * interval + vmin
    center = probs.argmax(axis=1)
    idx = np.arange(bins)[None, :]
    window = (idx >= center[:, None] - width) & (idx <= center[:, None] + width)
    w = probs * window
    total = w.sum(axis=1)
    pitch = (w * values).sum(axis=1) / np.where(total == 0, 1.0, total)
    return pitch, probs.max(axis=1) >= threshold


def note_ids(bounds: np.ndarray) -> np.ndarray:
    """boundary probabilities [T] -> 1-based note id of each frame."""
    steps = np.round(np.cumsum(bounds)).astype(np.int64)
    rises = np.diff(steps, prepend=-1) > 0
    return np.cumsum(rises)


def decode_notes(probs: np.ndarray, bounds: np.ndarray, vmin: float, vmax: float,
                 deviation: float, threshold: float):
    """One chunk's frames -> (note pitch [N], note frames [N], note rest [N])."""
    pitch, voiced = frame_pitch(probs, vmin, vmax, deviation, threshold)
    ids = note_ids(bounds)
    n = int(ids.max()) if len(ids) else 0
    frames = np.bincount(ids, minlength=n + 1)[1:]
    voiced_frames = np.bincount(ids, weights=voiced, minlength=n + 1)[1:]
    rest = ~(voiced_frames / np.maximum(frames, 1) >= 0.5)
    rounded = np.clip(np.round(pitch), 0, 127).astype(np.int64)
    hist = np.zeros((n + 1, 128))
    np.add.at(hist, (ids, rounded), voiced)
    center = hist.argmax(axis=1)[ids]
    near = voiced & (np.abs(pitch - center) <= 0.5)
    sums = np.bincount(ids, weights=pitch * near, minlength=n + 1)[1:]
    counts = np.bincount(ids, weights=near, minlength=n + 1)[1:]
    note_pitch = sums / np.where(counts == 0, 1.0, counts)
    return note_pitch, frames, rest


def frames_of_notes(pitch: np.ndarray, frames: np.ndarray, rest: np.ndarray) -> np.ndarray:
    """Notes -> pitch per frame, NaN on rest frames."""
    per = np.where(rest, np.nan, pitch)
    return np.repeat(per, frames)
