"""Training losses and the midi_acc counters.

Counterpart of ``some_tpu/training/losses.py`` (the functions the
continuous and the quantized tasks use), in f32 with the same formulas.
"""
from __future__ import annotations

import math

import torch


def bce_with_logits_elementwise(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Stable elementwise BCE with logits: max(x, 0) - x z + log(1 + exp(-|x|))."""
    logits = logits.float()
    return (torch.clamp(logits, min=0) - logits * target
            + torch.log1p(torch.exp(-logits.abs())))


def binary_emd_per_row(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-row EMD [B]: L1 between the cumsums over sqrt(T), averaged over T."""
    scale = math.sqrt(target.shape[1])
    return (torch.cumsum(pred, dim=1) / scale
            - torch.cumsum(target, dim=1) / scale).abs().mean(dim=1)


def binary_emd_per_row_masked(pred: torch.Tensor, target: torch.Tensor,
                              frame_w: torch.Tensor, t_real: torch.Tensor) -> torch.Tensor:
    """Per-row EMD over the first ``t_real`` frames only: frames past it
    (bucket padding) enter neither the cumsums, nor the sum, nor the
    normalisers."""
    denom = torch.clamp(t_real, min=1.0)
    scale = torch.sqrt(denom)
    diff = (torch.cumsum(pred * frame_w, dim=1)
            - torch.cumsum(target * frame_w, dim=1)).abs() / scale
    return (diff * frame_w).sum(dim=1) / denom


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = -1, count_sum=None) -> torch.Tensor:
    """logits [B, T, C], int labels [B, T]: the mean over the labels that are
    not ``ignore_index`` of the f32 log-sum-exp minus the picked logit.
    ``count_sum`` (the count's sum over processes) makes the mean's divisor
    the global batch's."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    top = logits.amax(dim=-1, keepdim=True)
    logz = torch.log(torch.exp(logits - top).sum(dim=-1)) + top.squeeze(-1)
    picked = torch.gather(logits, -1, safe[..., None]).squeeze(-1)
    nll = (logz - picked) * valid
    count = valid.sum() if count_sum is None else count_sum(valid.sum())
    return nll.sum() / torch.clamp(count, min=1)


def midi_accuracy_counts(midi_pred, rest_pred, midi_gt, rest_gt, mask=None,
                         tolerance: float = 0.5):
    """(correct, total) int32 counters of the midi_acc metric."""
    midi_close = (~rest_pred) & (~rest_gt) & ((midi_pred - midi_gt).abs() <= tolerance)
    overall = midi_close & (rest_pred == rest_gt)
    if mask is not None:
        overall = overall & mask
        total = mask.sum()
    else:
        total = torch.tensor(midi_gt.numel())
    return overall.sum().to(torch.int32), total.to(torch.int32)
