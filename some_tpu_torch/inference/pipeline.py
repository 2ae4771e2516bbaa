"""Waveform -> MIDI recipe shared by the serving surfaces.

Counterpart of ``some_tpu/inference/pipeline.py``: silence slicing with the
production slicer settings, ``engine.infer``, SMF assembly, and the JSON
wire schema of the serving surfaces (``serve``'s ``format=json`` bodies and
``stream``'s NDJSON events), field for field the JAX package's.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from some_tpu_torch.audio.slicer import SilenceSlicer
from some_tpu_torch.utils.midi_file import build_midi_file

#: Input-length cap of the interactive surfaces (reference webui.py:43-44).
MAX_DURATION_SEC = 20 * 60

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


def segment_to_json(offset: float, seg: dict) -> Dict[str, object]:
    """One segment in the wire schema shared by ``serve``'s ``format=json``
    and ``stream``'s NDJSON events."""
    return {
        "offset_sec": float(offset),
        "note_midi": np.asarray(seg["note_midi"], float).tolist(),
        "note_dur_sec": np.asarray(seg["note_dur"], float).tolist(),
        "note_rest": np.asarray(seg["note_rest"], bool).tolist(),
    }


def segments_to_json(offsets, segments, tempo: float) -> Dict[str, object]:
    """JSON-safe note arrays (``serve``'s ``format=json`` body)."""
    return {"segments": [segment_to_json(o, s) for o, s in zip(offsets, segments)],
            "tempo": tempo}
