"""Framewise -> note-level decoders with static shapes.

Counterpart of ``some_tpu/ops/decode.py``. Segment sums over a
data-dependent note count use the static bound of ``T + 1`` segments per row
(note ids 1..T, slot 0 is padding) and ``index_add_`` over a flat
``[B * (T + 1)]`` index, so no shape depends on the data and nothing waits
for the device. Outputs are ``[B, T]`` arrays padded with zeros beyond the
true note count. ``torch.round`` rounds half to even, as ``jnp.round`` does.

On CUDA a float ``index_add_`` is atomic, so its summation order varies from
run to run: integer counts are exact, note values agree to f32 rounding.
"""
from __future__ import annotations

import torch


def decode_gaussian_blurred_probs(probs: torch.Tensor, vmin: float, vmax: float,
                                  deviation: float, threshold: float):
    """Soft-argmax over a +-3-sigma window around the peak bin.

    probs: [B, T, N] -> (values [B, T] float midi, rest [B, T] bool)."""
    num_bins = probs.shape[-1]
    interval = (vmax - vmin) / (num_bins - 1)
    width = int(3 * deviation / interval)
    idx = torch.arange(num_bins, device=probs.device)[None, None, :]
    idx_values = idx * interval + vmin
    center = torch.argmax(probs, dim=-1, keepdim=True)
    start = torch.clamp(center - width, min=0)
    end = torch.clamp(center + width + 1, max=num_bins)
    window_mask = (idx >= start) & (idx < end)
    weights = probs * window_mask
    product_sum = torch.sum(weights * idx_values, dim=2)
    weight_sum = torch.sum(weights, dim=2)
    values = product_sum / (weight_sum + (weight_sum == 0))
    rest = torch.amax(probs, dim=-1) < threshold
    return values, rest


def decode_bounds_to_alignment(bounds: torch.Tensor, use_diff: bool = True) -> torch.Tensor:
    """Boundary probabilities [B, T] -> frame-to-note index map [B, T] int32
    (1-based): cumsum -> round -> increment detection -> cumsum."""
    bounds_step = torch.round(torch.cumsum(bounds, dim=1)).to(torch.int32)
    if use_diff:
        prev = torch.cat([torch.full_like(bounds_step[:, :1], -1), bounds_step[:, :-1]], dim=1)
        bounds_inc = (bounds_step - prev) > 0
    else:
        first = torch.ones_like(bounds_step[:, :1], dtype=torch.bool)
        bounds_inc = torch.cat([first, bounds_step[:, 1:] > bounds_step[:, :-1]], dim=1)
    return torch.cumsum(bounds_inc.to(torch.int32), dim=1).to(torch.int32)


def decode_note_sequence(frame2item: torch.Tensor, values: torch.Tensor,
                         masks: torch.Tensor, threshold: float = 0.5):
    """Aggregate framewise values into notes.

    frame2item: [B, T] int (0 = padding), values: [B, T] float, masks: [B, T]
    bool. Returns (item_values, item_dur, item_masks), each [B, T]; the valid
    entries are [:, :n_items] with n_items = frame2item.max(1)."""
    B, T = frame2item.shape
    n_seg = T + 1
    dev = frame2item.device
    items = frame2item.long()
    row = torch.arange(B, device=dev)[:, None]
    flat_items = (items + row * n_seg).reshape(-1)

    def segment_sum(data: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(B * n_seg, dtype=data.dtype, device=dev)
        out.index_add_(0, flat_items, data.reshape(-1))
        return out.view(B, n_seg)[:, 1:]

    masks_i = masks.to(torch.int32)
    item_dur = segment_sum(torch.ones_like(masks_i))
    item_unmasked = segment_sum(masks_i)
    safe_dur = item_dur + (item_dur == 0)
    item_masks = (item_unmasked / safe_dur) >= threshold

    values_quant = torch.clamp(torch.round(values).to(torch.int32), 0, 127).long()
    hist_ids = ((items + row * n_seg) * 128 + values_quant).reshape(-1)
    histogram = torch.zeros(B * n_seg * 128, dtype=torch.int32, device=dev)
    histogram.index_add_(0, hist_ids, masks_i.reshape(-1))
    histogram = histogram.view(B, n_seg, 128)[:, 1:]
    item_center = torch.argmax(histogram, dim=2).to(values.dtype)  # [B, T]
    center_padded = torch.cat([torch.zeros_like(item_center[:, :1]), item_center], dim=1)
    values_center = torch.gather(center_padded, 1, items)
    near_center = masks & (values >= values_center - 0.5) & (values <= values_center + 0.5)

    item_valid_dur = segment_sum(near_center.to(torch.int32))
    item_values_sum = segment_sum(values * near_center)
    item_values = item_values_sum / (item_valid_dur + (item_valid_dur == 0))
    return item_values, item_dur, item_masks
