"""Note-level transcription metrics: onset / onset+pitch / onset+offset F1.

Copy of ``some_tpu/utils/note_f1.py`` (mir_eval.transcription semantics:
greedy one-to-one matching, onset within ``onset_tolerance`` seconds, pitch
within ``pitch_tolerance`` semitones, optional offset criterion).
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


def match_notes(ref: Tuple[np.ndarray, np.ndarray, np.ndarray],
                pred: Tuple[np.ndarray, np.ndarray, np.ndarray],
                onset_tolerance: float = 0.05,
                pitch_tolerance: float = 0.5,
                offset_ratio: float | None = None,
                offset_min_tolerance: float = 0.05) -> List[Tuple[int, int]]:
    """Greedy matching by onset distance among all valid candidate pairs."""
    r_on, r_off, r_pitch = ref
    p_on, p_off, p_pitch = pred
    candidates = []
    for i in range(len(r_on)):
        for j in range(len(p_on)):
            if abs(r_on[i] - p_on[j]) > onset_tolerance:
                continue
            if abs(r_pitch[i] - p_pitch[j]) > pitch_tolerance:
                continue
            if offset_ratio is not None:
                tol = max(offset_ratio * (r_off[i] - r_on[i]), offset_min_tolerance)
                if abs(r_off[i] - p_off[j]) > tol:
                    continue
            candidates.append((abs(r_on[i] - p_on[j]), i, j))
    candidates.sort()
    matched_r, matched_p, matches = set(), set(), []
    for _, i, j in candidates:
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

