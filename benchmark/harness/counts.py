"""The yardstick's arithmetic: the card's peaks, a kernel's least time, and
the model's operations.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity, at its
700 W limit). A kernel's least time is the larger of its operations over the
configuration precision's peak and its bytes over the memory's rate; the
operations and bytes come from the real shapes (each input and output byte
once in its dtype), whatever implements the kernel. The attention and
depthwise counts are the ones the port's kernel table uses (frozen here).
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
#: MFU is taken against the bf16 dense peak in every configuration
MFU_PEAK = PEAK_FLOPS["bf16"]


def least_seconds(nbytes: float, flops: float, peak_flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops)


def key_pairs(real: np.ndarray, t_pad: int) -> int:
    """(query, key) pairs of one head that the attention function needs for
    rows with ``real`` real frames in a bucket of ``t_pad``: in a row with a
    real key every query against the real keys; in an all-padding row all
    ``t_pad**2`` (its keys carry the uniform average)."""
    real = np.asarray(real, np.float64)
    return int((t_pad * real + (real == 0) * t_pad * t_pad).sum())


def attention_work(kind: str, rows: int, t_pad: int, real: np.ndarray, heads: int,
                   head_dim: int, itemsize: int):
    """(bytes, flops) of one attention call over a [rows, t_pad] bucket.
    ``kind``: fwd (inference), fwd_res (training forward with statistics),
    bwd_dkv, bwd_dq."""
    B, H, T, D = rows, heads, t_pad, head_dim
    pairs = H * D * key_pairs(real, t_pad)
    bhtd = B * H * T * D * itemsize
    return {"fwd": (4 * bhtd + B * T, 4 * pairs),
            "fwd_res": (4 * bhtd + B * T + 8 * B * H * T, 4 * pairs),
            "bwd_dkv": (6 * bhtd + 12 * B * H * T + B * T, 8 * pairs),
            "bwd_dq": (5 * bhtd + 16 * B * H * T + B * T, 6 * pairs)}[kind]


def depthwise_work(rows: int, t_pad: int, channels: int, taps: int, itemsize: int):
    """(bytes, flops) of one depthwise call (forward, input or weight
    gradient) over a [rows, t_pad, channels] bucket."""
    return ((2 * rows * t_pad * channels + taps * channels) * itemsize,
            2 * rows * t_pad * channels * taps)


def model_flops(config: dict, frames: np.ndarray) -> float:
    """Forward operations of the model on sequences of ``frames`` real
    frames each: every Dense product and the depthwise taps per frame, and
    attention's score and value products over the real keys (no padding,
    no recompute)."""
    a = config["midi_extractor_args"]
    d, lay, k = a["dim"], a["lay"], a["kernel_size"]
    hidden = a["attention_heads"] * a["attention_heads_dim"]
    block = (2 * 2 * (d * 4 * d * 2)            # two macaron FFNs, two products each
             + 2 * (d * hidden + d * 2 * hidden + hidden * d)  # q, kv, out
             + 2 * (d * 2 * d + d * d)           # pointwise convs
             + 2 * k * d)                       # depthwise taps
    blocks = 2 * lay + 2
    per_frame = (blocks * block + lay * 2 * 2 * (d * 2 * d)   # the dual-stream gates
                 + 2 * 2 * config["units_dim"] * d            # input projections
                 + 2 * d * config["midi_num_bins"] + 2 * d)   # heads
    frames = np.asarray(frames, np.float64)
    attention = blocks * 4 * hidden * (frames ** 2).sum()
    return float(per_frame * frames.sum() + attention)
