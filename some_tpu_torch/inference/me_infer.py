"""Continuous-model inference: wire -> log-mel -> conformer -> gaussian decode.

Counterpart of ``some_tpu/inference/me_infer.py``. Everything from the wire
array to the fixed-shape note arrays runs on the engine's device, on the card
as one CUDA graph per bucket (``base_infer``); the host slices each row to
its note count (``assemble``) and repairs the seams of split chunks
(``merge_parts``). On a serving mesh each replica is an engine of this class
on its device, with its own mel frontend.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from some_tpu_torch.audio.wire import decode_wire_device
from some_tpu_torch.inference.base_infer import BaseInference
from some_tpu_torch.ops.decode import (
    decode_bounds_to_alignment, decode_gaussian_blurred_probs, decode_note_sequence,
)
from some_tpu_torch.ops.melspec import LogMelSpec


class MIDIExtractionInference(BaseInference):
    OUTPUT_KEYS = ("note_midi", "note_dur", "note_rest", "n_notes")
    FRAME_KEYS = ("probs", "bounds")

    def __init__(self, config: dict, model_path, **kwargs):
        super().__init__(config, model_path, **kwargs)
        self.midi_min = config["midi_min"]
        self.midi_max = config["midi_max"]
        self.midi_deviation = config["midi_prob_deviation"]
        self.rest_threshold = config["rest_threshold"]
        # max |delta midi| (semitones) for joining the voiced note that spans
        # a bucket-boundary split
        self.seam_merge_tol = float(config.get("seam_merge_midi_tol", 0.5))
        self._rebuild_wire_pipeline()

    def _rebuild_wire_pipeline(self) -> None:
        """The mel frontend in the wire's domain (factor f = 1 leaves it
        native): sample rate, window and hop divided by f keep every bin
        frequency, filterbank weight and frame time; ``mag_scale`` f makes
        up for the shorter window. Called at construction and on every flip
        of the auto wire policy, which also drops the captured graphs."""
        super()._rebuild_wire_pipeline()
        config, f = self.config, self.wire_factor
        self.mel = LogMelSpec(
            n_mels=config["units_dim"], sample_rate=config["audio_sample_rate"] // f,
            win_length=config["win_size"] // f, hop_length=config["hop_size"] // f,
            fmin=config["fmin"], fmax=config["fmax"],
            method=config.get("mel_method", "rfft"), device=self.device, mag_scale=float(f))

    def _decode(self, probs, bounds, mask):
        maskf = mask.to(probs.dtype)
        probs = probs * maskf[..., None]
        bounds = bounds * maskf
        frame2note = decode_bounds_to_alignment(bounds) * mask
        midi, rest = decode_gaussian_blurred_probs(
            probs, vmin=self.midi_min, vmax=self.midi_max,
            deviation=self.midi_deviation, threshold=self.rest_threshold)
        note_midi, note_dur, note_mask = decode_note_sequence(frame2note, midi, (~rest) & mask)
        return {"note_midi": note_midi, "note_dur": note_dur,
                "note_rest": ~note_mask, "n_notes": frame2note.amax(dim=1)}

    def _device_pipeline(self, audio, mask) -> dict:
        """Wire rows -> notes: nothing here waits for the card or depends on
        the data for a shape, so a bucket's run captures as one graph."""
        audio = decode_wire_device(audio, self.wire, n_samples=mask.shape[1] * self.hop - 1)
        units = self.mel(audio)
        probs, bounds = self._forward(units, mask)
        return dict(self._decode(probs, bounds, mask), probs=probs, bounds=bounds)

    def _forward(self, units, mask):
        """The model on log-mel units: (per-bin sigmoid probs, boundary probs)."""
        return self.model(units, mask=mask, sig=True)

    def assemble(self, device_out: dict, n_frames: int) -> Dict[str, np.ndarray]:
        n = int(device_out["n_notes"])
        return {
            "note_midi": np.asarray(device_out["note_midi"][:n], dtype=np.float32),
            "note_dur": np.asarray(device_out["note_dur"][:n], dtype=np.float64) * self.timestep,
            "note_rest": np.asarray(device_out["note_rest"][:n], dtype=bool),
        }

    def merge_parts(self, parts):
        """Seam repair for chunks split at the largest frame bucket: the note
        sounding across a split comes back as one note. The seam pair is
        (last note of part i, first note of part i+1); it joins when both are
        rests, or both voiced within seam_merge_tol semitones, with the pitch
        weighted by duration."""
        out = parts[0]
        for nxt in parts[1:]:
            out = self._join_seam(out, nxt)
        return out

    def _join_seam(self, a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]
                   ) -> Dict[str, np.ndarray]:
        if len(a["note_dur"]) == 0:
            return b
        if len(b["note_dur"]) == 0:
            return a
        rest_a = bool(a["note_rest"][-1])
        rest_b = bool(b["note_rest"][0])
        join = (rest_a and rest_b) or (
            not rest_a and not rest_b
            and abs(float(a["note_midi"][-1]) - float(b["note_midi"][0])) <= self.seam_merge_tol)
        if not join:
            return {k: np.concatenate([a[k], b[k]]) for k in a}
        da = float(a["note_dur"][-1])
        db = float(b["note_dur"][0])
        midi = (float(a["note_midi"][-1]) * da + float(b["note_midi"][0]) * db) / max(da + db, 1e-9)
        out = {k: np.concatenate([a[k], b[k][1:]]) for k in a}
        out["note_dur"][len(a["note_dur"]) - 1] = da + db
        out["note_midi"][len(a["note_midi"]) - 1] = midi
        return out
