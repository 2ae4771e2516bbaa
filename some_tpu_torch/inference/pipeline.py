"""Waveform -> MIDI recipe shared by the serving surfaces.

Counterpart of ``some_tpu/inference/pipeline.py``: silence slicing with the
production slicer settings, ``engine.infer``, SMF assembly.
"""
from __future__ import annotations

from typing import List

import numpy as np

from some_tpu_torch.audio.slicer import SilenceSlicer
from some_tpu_torch.utils.midi_file import build_midi_file

#: Longest silence (ms) kept around each chunk (reference infer.py:35).
MAX_SIL_KEPT_MS = 1000


def slice_waveform(waveform: np.ndarray, sr: int) -> List[dict]:
    """Silence-slice a mono waveform into phrase chunks with offsets."""
    return SilenceSlicer(sr=sr, max_sil_kept=MAX_SIL_KEPT_MS).slice(waveform)


def transcribe_waveform(engine, waveform: np.ndarray, sr: int, tempo: float = 120):
    """Full waveform -> MidiFile through a prepared inference engine."""
    chunks = slice_waveform(waveform, sr)
    segments = engine.infer([c["waveform"] for c in chunks])
    return build_midi_file([c["offset"] for c in chunks], segments, tempo=tempo)
