"""Host->device audio wire formats, chosen by the ``transfer_dtype`` config key.

Counterpart of ``some_tpu/audio/wire.py``:

  * ``int16`` (default) — 2 B/sample; exactly reproduces 16-bit-PCM-sourced
    waveforms after the on-device /32768.
  * ``float32`` — 4 B/sample, bit-exact for arbitrary float sources.
  * ``mulaw12`` — 1.5 B/sample: mu-law (mu = 255) quantized to 12 bits,
    sample pairs packed into 3 bytes; code 2048 is exact silence.
  * ``mulaw8`` — 1 B/sample, mu-law, 8 bits; code 128 is silence (a
    zero-filled buffer would decode to a -1.0 plateau).

The host side (``encode_wire``, the silence buffers) is numpy and gives the
JAX package's codes bit for bit. The device side (``decode_wire_device``)
takes the wire by name, because ``mulaw8`` and packed ``mulaw12`` are both
``uint8``. Its mu-law expansion is the JAX formula in f32 torch ops; XLA's
``expm1`` (and its rewrite of the division under ``jit``) round differently,
so the decoded mu-law samples agree with the JAX package's to a few f32 ulp.
"""
from __future__ import annotations

import numpy as np
import torch

WIRES = ("int16", "float32", "mulaw8", "mulaw12")
MU = 255.0
_TORCH_DTYPES = {"int16": torch.int16, "float32": torch.float32, "mulaw8": torch.uint8,
                 "mulaw12": torch.uint8}


def check_wire(wire: str) -> None:
    if wire not in WIRES:
        raise ValueError(f"unknown transfer_dtype {wire!r} (have {WIRES} and 'auto')")


def wire_np_dtype(wire: str):
    check_wire(wire)
    return {"int16": np.int16, "mulaw8": np.uint8, "mulaw12": np.uint8}.get(wire, np.float32)


def wire_zero(wire: str):
    """The wire code of silence for a scalar-per-sample format (mulaw8's is
    128). mulaw12 packs two samples into three bytes and has none: use
    :func:`silence_buffer`."""
    if wire == "mulaw12":
        raise ValueError("mulaw12 is packed (3 bytes per 2 samples); use silence_buffer")
    return encode_wire(np.zeros(1, np.float32), wire)[0]


def wire_width(wire: str, n_samples: int) -> int:
    """Length of the last (wire) axis of an ``n_samples`` row."""
    check_wire(wire)
    if wire == "mulaw12":
        return ((n_samples + 1) // 2) * 3
    return n_samples


def silence_buffer(wire: str, rows: int, n_samples: int) -> np.ndarray:
    """[rows, wire_width] buffer whose every row decodes to exact silence."""
    row = encode_wire(np.zeros(n_samples, np.float32), wire)
    return np.broadcast_to(row, (rows, len(row))).copy()


def _mulaw_compress(wave: np.ndarray) -> np.ndarray:
    x = np.clip(wave, -1.0, 1.0)
    return np.sign(x) * np.log1p(MU * np.abs(x)) / np.log1p(MU)


def encode_wire(wave: np.ndarray, wire: str) -> np.ndarray:
    """float32 [-1, 1] waveform -> wire-format array (host side, numpy).

    Works on [..., n] arrays; the last axis is the sample axis. mulaw12 pads
    an odd sample count with one silence sample so every packed group is
    complete."""
    check_wire(wire)
    if wire == "int16":
        return np.clip(np.round(wave * 32768.0), -32768, 32767).astype(np.int16)
    if wire == "mulaw8":
        return np.round((_mulaw_compress(wave) + 1.0) * 127.5).astype(np.uint8)
    if wire == "mulaw12":
        wave = np.asarray(wave, np.float32)
        if wave.shape[-1] % 2:
            wave = np.pad(wave, [(0, 0)] * (wave.ndim - 1) + [(0, 1)])
        # midtread: code 2048 is exact silence; codes 1..4095, 0 unused
        codes = (np.round(_mulaw_compress(wave) * 2047.0) + 2048).astype(np.uint16)
        c = codes.reshape(*codes.shape[:-1], -1, 2).astype(np.uint32)
        packed = np.stack([c[..., 0] >> 4, ((c[..., 0] & 0xF) << 4) | (c[..., 1] >> 8),
                           c[..., 1] & 0xFF], axis=-1)
        return packed.reshape(*codes.shape[:-1], -1).astype(np.uint8)
    return np.asarray(wave, np.float32)


def _mulaw_expand(y: torch.Tensor) -> torch.Tensor:
    return torch.sign(y) * (torch.expm1(torch.abs(y) * float(np.float32(np.log1p(MU)))) / MU)


def decode_wire_device(audio: torch.Tensor, wire: str, n_samples: int | None = None
                       ) -> torch.Tensor:
    """Wire tensor -> float32 waveform on the tensor's device. A float tensor
    passes through whatever ``wire`` says (as in the JAX package); any other
    must have the wire's dtype. ``n_samples`` cuts a row back to its true
    sample count (mulaw12 pads odd counts)."""
    check_wire(wire)
    if audio.dtype.is_floating_point:
        out = audio.float()
    elif audio.dtype != _TORCH_DTYPES[wire]:
        raise TypeError(f"a {wire} wire tensor must be {_TORCH_DTYPES[wire]}, got {audio.dtype}")
    elif wire == "int16":
        out = audio.float() * (1.0 / 32768.0)
    elif wire == "mulaw8":
        out = _mulaw_expand(audio.float() * (1.0 / 127.5) - 1.0)
    else:
        b = audio.to(torch.int32).reshape(*audio.shape[:-1], -1, 3)
        c0 = (b[..., 0] << 4) | (b[..., 1] >> 4)
        c1 = ((b[..., 1] & 0xF) << 8) | b[..., 2]
        codes = torch.stack([c0, c1], dim=-1).reshape(*audio.shape[:-1], -1)
        out = _mulaw_expand((codes.float() - 2048.0) * (1.0 / 2047.0))
    if n_samples is not None:
        out = out[..., :n_samples]
    return out
