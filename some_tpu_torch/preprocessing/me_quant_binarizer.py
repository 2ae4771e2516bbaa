"""Quantized binarizer: integer MIDI, rest class 128, integer key shifts
(reference: preprocessing/me_quant_binarizer.py:22-51). Port of
``some_tpu/preprocessing/me_quant_binarizer.py``."""
from __future__ import annotations

import math
import random
from typing import List

from some_tpu_torch.audio.wavio import load_wav
from some_tpu_torch.preprocessing.me_binarizer import MIDIExtractionBinarizer

QUANTIZED_MIDI_EXTRACTION_ITEM_ATTRIBUTES = [
    "units",      # float32 [T_s, C]
    "pitch",      # float32 [T_s]
    "note_midi",  # int64 [T_n], 0-127 MIDI / 128 rest
    "note_dur",   # int64 [T_n] frames
    "unit2note",  # int64 [T_s]
]


class QuantizedMIDIExtractionBinarizer(MIDIExtractionBinarizer):
    def __init__(self, config: dict, device=None):
        super().__init__(config, device=device)
        self.round_midi = True
        self.data_attrs = QUANTIZED_MIDI_EXTRACTION_ITEM_ATTRIBUTES

    def process_item(self, item_name: str, meta_data: dict,
                     allow_aug: bool = False) -> List[dict]:
        waveform, _ = load_wav(meta_data["wav_fn"],
                               sr=self.config["audio_sample_rate"], mono=True)
        base = self._process_item(waveform, meta_data, int_midi=True,
                                  item_name=item_name)
        base["note_midi"] = base["note_midi"].copy()
        base["note_midi"][base["note_rest"]] = 128
        items = [base]
        if not allow_aug:
            return items
        rng = random.Random(f"{self.config.get('seed', 0)}:{item_name}")
        # rests (class 128) are never shifted; clamp to the voiced range so
        # no shifted label leaves [midi_min, midi_max] (see
        # MIDIExtractionBinarizer._effective_shift_range)
        shift_range = self._effective_shift_range(
            base["note_midi"][~base["note_rest"]])
        if shift_range is None:
            return items
        lo, hi = math.ceil(shift_range[0]), math.floor(shift_range[1])
        if lo > hi:  # float range contains no integer shift
            return items
        for _ in range(self.key_shift_factor):
            assert self.config["units_encoder"] == "mel", \
                "Units encoder must be mel if augmentation is applied!"
            shift = rng.randint(lo, hi)
            aug = dict(base)
            aug["units"] = self.compute_units(waveform, keyshift=shift)
            aug["pitch"] = base["pitch"] + shift
            note_midi = base["note_midi"].copy()
            note_midi[~base["note_rest"]] += shift
            aug["note_midi"] = note_midi
            items.append(aug)
        return items
