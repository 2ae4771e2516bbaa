"""Device log-mel frontend, ``rfft`` method.

Counterpart of ``some_tpu/ops/melspec.py::LogMelSpec``: center pad
(win//2 left, (win+1)//2 right) -> periodic-hann frames -> rFFT magnitude,
trimmed to the mel filterbank's support (the removed bins carry zero
weight) -> mel matmul -> log(clamp). The JAX package computes this outside
Pallas, so ``torch.fft.rfft`` and a plain matmul are its counterparts. The
``dft`` method is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from some_tpu_torch.audio.mel import hann_window, mel_filterbank


class LogMelSpec:
    """Precomputed constants on ``device`` + ``__call__`` for batched waveforms."""

    def __init__(self, n_mels: int, sample_rate: int, win_length: int, hop_length: int,
                 fmin: float = 0, fmax: float | None = None, clamp: float = 1e-5,
                 method: str = "rfft", device: torch.device | str = "cpu"):
        if method != "rfft":
            raise NotImplementedError(
                f"mel_method {method!r} is not ported yet (rfft only): see ROADMAP.md")
        self.n_fft = win_length
        self.win_length = win_length
        self.hop_length = hop_length
        self.n_mels = n_mels
        self.clamp = clamp
        self.window = torch.tensor(hann_window(win_length), dtype=torch.float32, device=device)
        basis = mel_filterbank(sample_rate, self.n_fft, n_mels, fmin, fmax)
        used = np.nonzero(basis.any(axis=0))[0]
        self._k_lo, self._k_hi = ((int(used[0]), int(used[-1]) + 1) if len(used)
                                  else (0, self.n_fft // 2 + 1))
        self.basis_trim = torch.tensor(basis[:, self._k_lo:self._k_hi], device=device)

    def num_frames(self, n_samples: int) -> int:
        return n_samples // self.hop_length + 1

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, N] (or [N]) -> float32 log-mel [B, F, n_mels] with F = N//hop + 1."""
        squeeze = audio.dim() == 1
        if squeeze:
            audio = audio[None]
        audio = torch.nn.functional.pad(
            audio.float(), (self.win_length // 2, (self.win_length + 1) // 2))
        frames = audio.unfold(-1, self.n_fft, self.hop_length)  # [B, F, n_fft]
        spec = torch.fft.rfft(frames * self.window, dim=-1)
        magnitude = spec[..., self._k_lo:self._k_hi].abs()
        mel = torch.matmul(magnitude, self.basis_trim.T)
        out = torch.log(torch.clamp(mel, min=self.clamp))
        return out[0] if squeeze else out
