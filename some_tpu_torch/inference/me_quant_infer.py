"""Quantized-model inference: softmax over 129 classes, argmax decode with
rest class 128.

Counterpart of ``some_tpu/inference/me_quant_infer.py`` (the model of
``configs/discrete.yaml``, ``task_cls: training.QuantizedMIDIExtractionTask``).
The engine is the continuous one's: its device pipeline, this forward and
this decode included, is one CUDA graph per bucket on the card, and on a
serving mesh each replica is an engine of this class.
"""
from __future__ import annotations

import torch

from some_tpu_torch.inference.me_infer import MIDIExtractionInference
from some_tpu_torch.ops.decode import decode_bounds_to_alignment, decode_note_sequence

REST_CLASS = 128


class QuantizedMIDIExtractionInference(MIDIExtractionInference):
    def __init__(self, config: dict, model_path, **kwargs):
        # the discrete configs lack the continuous decode's keys
        config.setdefault("midi_prob_deviation", 1.0)
        config.setdefault("rest_threshold", 0.1)
        super().__init__(config, model_path, **kwargs)

    def _forward(self, units, mask):
        return self.model(units, mask=mask, softmax=True)

    def _decode(self, probs, bounds, mask):
        maskf = mask.to(probs.dtype)
        probs = probs * maskf[..., None]
        bounds = bounds * maskf
        frame2note = decode_bounds_to_alignment(bounds) * mask
        midi = probs.argmax(dim=-1)  # the first of equal maxima, as jnp.argmax
        rest = midi == REST_CLASS
        note_midi, note_dur, note_mask = decode_note_sequence(
            frame2note, torch.clamp(midi, 0, 127).float(), (~rest) & mask)
        return {"note_midi": note_midi, "note_dur": note_dur,
                "note_rest": ~note_mask, "n_notes": frame2note.amax(dim=1)}
