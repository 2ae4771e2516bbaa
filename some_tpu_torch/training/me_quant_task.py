"""Quantized MIDI-extraction task: integer pitch classes and rest class 128.

Counterpart of ``some_tpu/training/me_quant_task.py`` (``configs/discrete.yaml``,
129 classes). The midi loss is a cross-entropy over the classes on
framewise labels, gathered on the device from the note labels through the
``unit2note`` alignment; frame slot 0, the padding of a bucket and the rows
that pad the batch carry label -1 and drop out. The boundary loss is the
continuous task's. Validation decodes notes by argmax and counts
``midi_acc``; its plots wait, as for the continuous task.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from some_tpu_torch.data.collate import collate_nd, pad_to_bucket
from some_tpu_torch.inference.me_quant_infer import REST_CLASS
from some_tpu_torch.ops.decode import decode_bounds_to_alignment, decode_note_sequence
from some_tpu_torch.training import losses as L
from some_tpu_torch.training.me_task import MIDIExtractionTask, bounds_from_alignment


def framewise_labels(note_midi: torch.Tensor, unit2note: torch.Tensor,
                     ignore_index: int = -1) -> torch.Tensor:
    """[B, N] int labels -> [B, T] through the alignment; slot 0 is ``ignore_index``."""
    padded = F.pad(note_midi, (1, 0), value=ignore_index)
    return torch.gather(padded, 1, unit2note.long())


class QuantizedMIDIExtractionTask(MIDIExtractionTask):
    def __init__(self, config: dict, device=None):
        # the discrete configs lack the continuous-only keys
        config.setdefault("midi_prob_deviation", 1.0)
        config.setdefault("rest_threshold", 0.1)
        super().__init__(config, device)

    def compute_losses(self, outputs, batch) -> Dict[str, torch.Tensor]:
        midi_logits, bounds_pred = outputs
        row_w = batch["batch_mask"].float()
        n_rows = torch.clamp(row_w.sum(), min=1.0)
        losses = {}
        if self.use_midi_loss:
            labels = framewise_labels(batch["note_midi"], batch["unit2note"])
            labels = torch.where(batch["batch_mask"][:, None], labels, torch.full_like(labels, -1))
            losses["midi_loss"] = L.cross_entropy_ignore(midi_logits, labels)
        if self.use_bound_loss:
            target = bounds_from_alignment(batch["unit2note"])
            t_real, frame_w = self._frame_weights(batch, bounds_pred.shape[1])
            if frame_w is None:
                per_row = L.binary_emd_per_row(bounds_pred, target)
            else:
                per_row = L.binary_emd_per_row_masked(bounds_pred, target, frame_w, t_real)
            losses["bound_loss"] = (per_row * row_w).sum() / n_rows
        return losses

    def valid_outputs(self, outputs, batch) -> dict:
        """Argmax decode and the midi_acc counters, on the device."""
        midi_logits, bounds = outputs
        masks = batch["unit2note"] > 0
        probs = torch.softmax(midi_logits.float(), dim=-1) * masks[..., None]
        bounds = bounds * masks
        frame2note = decode_bounds_to_alignment(bounds) * masks
        midi_idx = probs.argmax(dim=-1)
        rest_pred = midi_idx == REST_CLASS
        midi_pred = torch.where(rest_pred, -torch.inf, midi_idx.float())
        note_midi, note_dur, note_mask = decode_note_sequence(
            frame2note, torch.clamp(midi_idx, 0, 127).float(), (~rest_pred) & masks)
        gt_notes = batch["note_midi"].float()
        gt_notes = torch.where(batch["note_midi"] == REST_CLASS, -torch.inf, gt_notes)
        gt = F.pad(gt_notes, (1, 0), value=-torch.inf)
        midi_gt = torch.gather(gt, 1, batch["unit2note"].long())
        row_mask = masks & batch["batch_mask"][:, None]
        correct, total = L.midi_accuracy_counts(midi_pred, rest_pred, midi_gt, midi_gt < 0,
                                                mask=row_mask, tolerance=0.5)
        return {"probs": probs[..., :-1], "bounds": bounds, "note_midi": note_midi,
                "note_dur": note_dur, "note_rest": ~note_mask,
                "n_notes": frame2note.amax(dim=1), "midi_pred": midi_pred, "midi_gt": midi_gt,
                "midi_acc_correct": correct, "midi_acc_total": total}

    def collate(self, items: list) -> dict:
        batch = {"units": collate_nd([i["units"] for i in items]),
                 "pitch": collate_nd([i["pitch"] for i in items]),
                 "note_midi": collate_nd([i["note_midi"] for i in items], pad_value=-1),
                 "note_dur": collate_nd([i["note_dur"] for i in items]),
                 "unit2note": collate_nd([i["unit2note"] for i in items]),
                 "note_mask": collate_nd([np.ones(len(i["note_midi"]), dtype=bool)
                                          for i in items])}
        return pad_to_bucket(
            batch, length_grid=int(self.config.get("frame_bucket_grid", 128)),
            length_keys=("units", "pitch", "unit2note"),
            note_keys=("note_midi", "note_dur", "note_mask"),
            note_pad_values={"note_midi": -1})
