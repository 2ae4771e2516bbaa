"""Host->device audio wire formats: ``int16`` and ``float32``.

Counterpart of ``some_tpu/audio/wire.py`` for the two lossless wires:

  * ``int16`` (default) — 2 B/sample; exactly reproduces 16-bit-PCM-sourced
    waveforms after the on-device /32768.
  * ``float32`` — 4 B/sample, bit-exact for arbitrary float sources.

The lossy mu-law wires and ``transfer_dtype: auto`` are not ported yet and
raise ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

WIRES = ("int16", "float32")


def _check(wire: str) -> None:
    if wire not in WIRES:
        raise NotImplementedError(
            f"transfer_dtype {wire!r} is not ported yet (have {WIRES}); the "
            "mu-law wires and 'auto' are still to port: see ROADMAP.md")


def encode_wire(wave: np.ndarray, wire: str) -> np.ndarray:
    """float32 [-1, 1] waveform -> wire-format array (host side, numpy)."""
    _check(wire)
    if wire == "int16":
        return np.clip(np.round(wave * 32768.0), -32768, 32767).astype(np.int16)
    return np.asarray(wave, np.float32)


def silence_buffer(wire: str, rows: int, n_samples: int) -> np.ndarray:
    """[rows, n_samples] buffer whose every row decodes to exact silence."""
    row = encode_wire(np.zeros(n_samples, np.float32), wire)
    return np.broadcast_to(row, (rows, len(row))).copy()


def decode_wire_device(audio: torch.Tensor, n_samples: int | None = None) -> torch.Tensor:
    """Wire tensor -> float32 waveform on the tensor's device. The dtype
    names the wire: int16 is scaled by 1/32768, floats pass through."""
    if audio.dtype == torch.int16:
        out = audio.float() * (1.0 / 32768.0)
    elif audio.dtype.is_floating_point:
        out = audio.float()
    else:
        raise NotImplementedError(f"no wire decode for {audio.dtype} (int16 | float)")
    if n_samples is not None:
        out = out[..., :n_samples]
    return out
