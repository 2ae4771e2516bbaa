"""Host-side collation with shape bucketing.

Counterpart of ``some_tpu/data/collate.py``, numpy only and giving the same
arrays. ``collate_nd`` pads a list of arrays on the first axis and stacks;
``pad_to_bucket`` rounds the time axis up to a grid and the batch axis up to
a power of two, and adds the masks the task reads. On the card the grid
bounds the number of distinct shapes the kernels and the caching allocator
see; the loss excludes the padding either way.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def collate_nd(values: Sequence[np.ndarray], pad_value=0, max_len: int | None = None
               ) -> np.ndarray:
    """Pad along axis 0 to the max (or given) length and stack."""
    values = [np.asarray(v) for v in values]
    length = max(v.shape[0] for v in values) if max_len is None else max_len
    out = np.full((len(values), length, *values[0].shape[1:]), pad_value,
                  dtype=values[0].dtype)
    for i, v in enumerate(values):
        out[i, :v.shape[0]] = v
    return out


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def bucket_length(n: int, grid: int = 128, min_len: int | None = None) -> int:
    """Round a sequence length up to the bucket grid."""
    out = round_up(max(n, 1), grid)
    return out if min_len is None else max(out, min_len)


def bucket_batch_size(b: int) -> int:
    """Round a batch size up to the next power of two."""
    out = 1
    while out < b:
        out *= 2
    return out


def pad_to_bucket(batch: dict, length_grid: int = 128, pad_batch: bool = True,
                  length_keys: tuple = ("units", "pitch", "unit2note"),
                  note_keys: tuple = ("note_midi", "note_rest", "note_dur"),
                  note_pad_values: dict | None = None) -> dict:
    """Pad every array of a collated batch up to bucketed shapes.

    Adds ``mask`` [B, T] (True on real frames), ``batch_mask`` [B] (True on
    real rows), ``t_real`` (1,) (the length before bucketing, which the
    losses normalise by) and ``size`` (the real row count). The JAX
    package's cross-rank maxima (``common``, ``min_batch``) belong to
    multi-process training, which the port leaves out."""
    note_pad_values = note_pad_values or {}
    out = dict(batch)
    any_seq = out[length_keys[0]]
    B, T = any_seq.shape[0], any_seq.shape[1]
    T_pad = bucket_length(T, length_grid)
    B_pad = bucket_batch_size(B) if pad_batch else B

    def pad_arr(arr, target_t, pad_value=0):
        pads = [(0, B_pad - arr.shape[0]), (0, target_t - arr.shape[1])]
        pads += [(0, 0)] * (arr.ndim - 2)
        return np.pad(arr, pads, constant_values=pad_value)

    for key in length_keys:
        if out.get(key) is not None:
            out[key] = pad_arr(out[key], T_pad)
    if note_keys:
        note_t = max((out[k].shape[1] for k in note_keys if k in out), default=0)
        note_t_pad = bucket_length(note_t, max(length_grid // 4, 1)) if note_t else 0
        for key in note_keys:
            if out.get(key) is not None:
                out[key] = pad_arr(out[key], note_t_pad, note_pad_values.get(key, 0))

    if "mask" not in out:
        mask = np.zeros((B_pad, T_pad), dtype=bool)
        if batch.get("unit2note") is not None:
            mask[:B, :T] = batch["unit2note"] > 0
        else:
            mask[:B, :T] = True
        out["mask"] = mask
    if "batch_mask" not in out:
        bm = np.zeros((B_pad,), dtype=bool)
        bm[:B] = True
        out["batch_mask"] = bm
    out["t_real"] = np.full((1,), T, np.int32)
    out["size"] = B
    return out
