"""Note-level transcription metrics: onset / onset+pitch / onset+offset F1.

Counterpart of ``some_tpu/utils/note_f1.py``, with its results
(mir_eval.transcription semantics: greedy one-to-one matching, onset within
``onset_tolerance`` seconds, pitch within ``pitch_tolerance`` semitones,
optional offset criterion).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass
class NoteF1:
    precision: float
    recall: float
    f1: float
    n_pred: int
    n_ref: int
    n_match: int


#: reference notes a block of the candidate search (bounds its memory)
_ROWS = 1024


def match_notes(ref: Tuple[np.ndarray, np.ndarray, np.ndarray],
                pred: Tuple[np.ndarray, np.ndarray, np.ndarray],
                onset_tolerance: float = 0.05,
                pitch_tolerance: float = 0.5,
                offset_ratio: float | None = None,
                offset_min_tolerance: float = 0.05) -> List[Tuple[int, int]]:
    """Greedy matching by onset distance among all valid candidate pairs.

    The JAX module's double loop over (reference, prediction) pairs, with
    the pairs' tests done by numpy a block of reference notes at a time:
    the same candidates and distances, taken in the same order (distance,
    then reference index, then prediction index)."""
    r_on, r_off, r_pitch = (np.asarray(a) for a in ref)
    p_on, p_off, p_pitch = (np.asarray(a) for a in pred)
    dists, rows, cols = [], [], []
    for lo in range(0, len(r_on), _ROWS):
        sl = slice(lo, lo + _ROWS)
        dist = np.abs(r_on[sl, None] - p_on[None, :])
        ok = (dist <= onset_tolerance) & (
            np.abs(r_pitch[sl, None] - p_pitch[None, :]) <= pitch_tolerance)
        if offset_ratio is not None:
            tol = np.maximum(offset_ratio * (r_off[sl] - r_on[sl]), offset_min_tolerance)
            ok &= np.abs(r_off[sl, None] - p_off[None, :]) <= tol[:, None]
        i, j = np.nonzero(ok)
        dists.append(dist[i, j])
        rows.append(i + lo)
        cols.append(j)
    matched_r, matched_p, matches = set(), set(), []
    if not dists:
        return matches
    dist, rows, cols = (np.concatenate(a) for a in (dists, rows, cols))
    for k in np.lexsort((cols, rows, dist)):
        i, j = int(rows[k]), int(cols[k])
        if i in matched_r or j in matched_p:
            continue
        matched_r.add(i)
        matched_p.add(j)
        matches.append((i, j))
    return matches


def note_f1(ref, pred, onset_tolerance: float = 0.05,
            pitch_tolerance: float = 0.5, offset_ratio: float | None = None,
            offset_min_tolerance: float = 0.05) -> NoteF1:
    matches = match_notes(ref, pred, onset_tolerance, pitch_tolerance,
                          offset_ratio, offset_min_tolerance)
    n_ref, n_pred, n_match = len(ref[0]), len(pred[0]), len(matches)
    precision = n_match / n_pred if n_pred else 0.0
    recall = n_match / n_ref if n_ref else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return NoteF1(precision, recall, f1, n_pred, n_ref, n_match)

