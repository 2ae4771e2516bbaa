"""Continuous MIDI-extraction task.

Counterpart of ``some_tpu/training/me_task.py``. The soft pitch targets
(gaussians around each note's pitch, gathered to frames through the
``unit2note`` alignment) and the boundary train are built on the device from
the raw note arrays. Losses: BCE with logits on the targets plus the
cumsum EMD on the boundaries; padding rows are weighted out by
``batch_mask``, and with ``loss_exclude_bucket_padding`` (default) the
frames past ``t_real`` (the bucket padding) are too. Validation decodes
notes on the device and counts ``midi_acc``; its plots wait, as the card's
machine has no matplotlib.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from some_tpu_torch.data.collate import collate_nd, pad_to_bucket
from some_tpu_torch.nn.model import build_midi_extractor
from some_tpu_torch.ops.decode import (
    decode_bounds_to_alignment, decode_gaussian_blurred_probs, decode_note_sequence,
)
from some_tpu_torch.training import losses as L
from some_tpu_torch.training.base_task import BaseTask


def gaussian_note_targets(note_midi, note_rest, note_mask, unit2note, midi_min: float,
                          midi_max: float, num_bins: int, deviation: float) -> torch.Tensor:
    """[B, N] note arrays -> framewise soft targets [B, T, num_bins]."""
    interval = (midi_max - midi_min) / (num_bins - 1)
    sigma = deviation / interval
    miu = ((note_midi - midi_min) / interval)[:, :, None]
    x = torch.arange(num_bins, dtype=torch.float32, device=note_midi.device)[None, None, :]
    probs = torch.exp(-0.5 * ((x - miu) / sigma) ** 2)
    probs = probs * (note_mask & ~note_rest)[:, :, None]
    probs = F.pad(probs, (0, 0, 1, 0))  # row 0: the padding note
    return torch.gather(probs, 1, unit2note.long()[:, :, None].expand(-1, -1, num_bins))


def bounds_from_alignment(unit2note: torch.Tensor) -> torch.Tensor:
    """unit2note [B, T] -> boundary train [B, T] float (the note id rises)."""
    prev = F.pad(unit2note[:, :-1], (1, 0))
    return ((unit2note - prev) > 0).float()


class MIDIExtractionTask(BaseTask):
    def __init__(self, config: dict, device=None):
        super().__init__(config, device)
        self.midi_min = config["midi_min"]
        self.midi_max = config["midi_max"]
        self.num_bins = config["midi_num_bins"]
        self.midi_deviation = config["midi_prob_deviation"]
        self.rest_threshold = config["rest_threshold"]
        self.use_bound_loss = config.get("use_bound_loss", True)
        self.use_midi_loss = config.get("use_midi_loss", True)
        self.loss_exclude_bucket_padding = config.get("loss_exclude_bucket_padding", True)

    def build_model(self):
        # int8 is serving-only: a work-dir config that carries the serving
        # key still trains the f32 model
        return build_midi_extractor(self.config, dtype=self.compute_dtype, quantize="none")

    def _frame_weights(self, batch, t_pad: int):
        """(t_real, [T] 0/1 weights), or (None, None) for the whole-tensor mean."""
        if not self.loss_exclude_bucket_padding or "t_real" not in batch:
            return None, None
        t_real = batch["t_real"][0].float()
        frame_w = (torch.arange(t_pad, device=t_real.device) < t_real).float()
        return t_real, frame_w

    def compute_losses(self, outputs, batch) -> Dict[str, torch.Tensor]:
        midi_logits, bounds_pred = outputs
        row_w = batch["batch_mask"].float()
        n_rows = torch.clamp(row_w.sum(), min=1.0)
        t_real, frame_w = self._frame_weights(batch, midi_logits.shape[1])
        losses = {}
        if self.use_midi_loss:
            target = gaussian_note_targets(
                batch["note_midi"], batch["note_rest"], batch["note_mask"], batch["unit2note"],
                self.midi_min, self.midi_max, self.num_bins, self.midi_deviation)
            per_elem = L.bce_with_logits_elementwise(midi_logits, target)
            if frame_w is None:
                losses["midi_loss"] = (per_elem.mean(dim=(1, 2)) * row_w).sum() / n_rows
            else:
                w = row_w[:, None, None] * frame_w[None, :, None]
                denom = n_rows * torch.clamp(t_real, min=1.0) * per_elem.shape[2]
                losses["midi_loss"] = (per_elem * w).sum() / denom
        if self.use_bound_loss:
            target = bounds_from_alignment(batch["unit2note"])
            if frame_w is None:
                per_row = L.binary_emd_per_row(bounds_pred, target)
            else:
                per_row = L.binary_emd_per_row_masked(bounds_pred, target, frame_w, t_real)
            losses["bound_loss"] = (per_row * row_w).sum() / n_rows
        return losses

    def valid_outputs(self, outputs, batch) -> dict:
        """Decoded notes and the midi_acc counters, on the device."""
        midi_logits, bounds = outputs
        masks = batch["unit2note"] > 0
        probs = torch.sigmoid(midi_logits.float()) * masks[..., None]
        bounds = bounds * masks
        frame2note = decode_bounds_to_alignment(bounds) * masks
        midi_pred, rest_pred = decode_gaussian_blurred_probs(
            probs, vmin=self.midi_min, vmax=self.midi_max,
            deviation=self.midi_deviation, threshold=self.rest_threshold)
        note_midi, note_dur, note_mask = decode_note_sequence(
            frame2note, midi_pred, (~rest_pred) & masks)
        gt = torch.where(batch["note_rest"], -torch.inf, batch["note_midi"])
        gt = F.pad(gt, (1, 0), value=-torch.inf)
        midi_gt = torch.gather(gt, 1, batch["unit2note"].long())
        row_mask = masks & batch["batch_mask"][:, None]
        shown = torch.where(rest_pred, -torch.inf, midi_pred)
        correct, total = L.midi_accuracy_counts(shown, rest_pred, midi_gt, midi_gt < 0,
                                                mask=row_mask, tolerance=0.5)
        return {"probs": probs, "bounds": bounds, "note_midi": note_midi,
                "note_dur": note_dur, "note_rest": ~note_mask,
                "n_notes": frame2note.amax(dim=1), "midi_pred": shown, "midi_gt": midi_gt,
                "midi_acc_correct": correct, "midi_acc_total": total}

    def collate(self, items: list) -> dict:
        batch = {key: collate_nd([i[key] for i in items])
                 for key in ("units", "pitch", "note_midi", "note_rest", "note_dur",
                             "unit2note")}
        batch["note_mask"] = collate_nd([np.ones(len(i["note_midi"]), dtype=bool)
                                         for i in items])
        return pad_to_bucket(
            batch, length_grid=int(self.config.get("frame_bucket_grid", 128)),
            length_keys=("units", "pitch", "unit2note"),
            note_keys=("note_midi", "note_rest", "note_dur", "note_mask"))
