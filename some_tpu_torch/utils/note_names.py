"""Note-name <-> MIDI conversions (librosa-compatible, no librosa dependency).

Copy of ``some_tpu/utils/note_names.py``.

The reference leans on ``librosa.note_to_midi`` / ``librosa.midi_to_note``
(with ``cents=True, unicode=False``) for dataset label parsing and writing
(reference: preprocessing/me_binarizer.py:70-79, batch_infer.py:37-46). These
reimplementations reproduce that behavior exactly for the ASCII note grammar
used by DiffSinger datasets (e.g. ``C4``, ``A#3``, ``Db5``, ``C4+30``,
``G3-25``), including cent suffixes and accidental stacking.
"""
from __future__ import annotations

import re
from typing import Union

import numpy as np

_PITCH_MAP = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}
_ACC_MAP = {"#": 1, "": 0, "b": -1, "!": -1, "♯": 1, "\U0001D12A": 2,
            "♭": -1, "\U0001D12B": -2, "♮": 0}
# Sharp-based chromatic spelling (librosa key_to_notes for C:maj, unicode off).
_NOTE_NAMES_SHARP = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]

_NOTE_RE = re.compile(
    r"^(?P<note>[A-Ga-g])"
    r"(?P<accidental>[#♯\U0001D12Ab!♭\U0001D12B♮]*)"
    r"(?P<octave>[+-]?\d+)?"
    r"(?P<cents>[+-]\d+)?$"
)


def note_to_midi(note: str, round_midi: bool = True) -> Union[int, float]:
    """Parse a note name into a (possibly fractional) MIDI number."""
    match = _NOTE_RE.match(note)
    if match is None:
        raise ValueError(f"Improper note format: {note!r}")
    pitch = _PITCH_MAP[match.group("note").upper()]
    offset = sum(_ACC_MAP[ch] for ch in match.group("accidental"))
    octave = int(match.group("octave")) if match.group("octave") else 0
    cents = int(match.group("cents")) * 1e-2 if match.group("cents") else 0.0
    value = 12 * (octave + 1) + pitch + offset + cents
    if round_midi:
        return int(np.round(value))
    return value


def midi_to_note(midi: Union[int, float], octave: bool = True, cents: bool = False,
                 unicode: bool = False) -> str:
    """Format a MIDI number as a note name, optionally with a cent marker."""
    note_num = int(np.round(midi))
    note_cents = int(100 * np.around(midi - note_num, 2))
    note = _NOTE_NAMES_SHARP[note_num % 12]
    if unicode:
        note = note.replace("#", "♯")
    if octave:
        note = f"{note}{note_num // 12 - 1}"
    if cents:
        note = f"{note}{note_cents:+02d}"
    return note


def hz_to_midi(frequencies):
    """12 * log2(f / 440 Hz) + 69 (librosa.hz_to_midi)."""
    return 12.0 * (np.log2(np.asarray(frequencies)) - np.log2(440.0)) + 69.0


def midi_to_hz(notes):
    return 440.0 * (2.0 ** ((np.asarray(notes, dtype=np.float64) - 69.0) / 12.0))
