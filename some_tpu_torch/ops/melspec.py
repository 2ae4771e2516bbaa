"""Device log-mel frontend.

Counterpart of ``some_tpu/ops/melspec.py::LogMelSpec``: center pad
(win//2 left, (win+1)//2 right) -> periodic-hann frames -> magnitude
spectrum over the mel filterbank's support (the bins outside it carry zero
weight) -> mel matmul -> log(clamp). Two spectrum methods, as in JAX:

* ``rfft`` (the default): ``torch.fft.rfft`` of the windowed frames;
* ``dft``: the windowed DFT as two real f32 matmuls over the filterbank's
  support, the window folded into the cos and sin matrices (built in f64,
  stored in f32), then ``sqrt(re^2 + im^2)``. Direct summation loses about
  1e-2 of log-mel accuracy to cancellation at quiet bins (the JAX
  docstring's figure), so the products run in full f32, TF32 off: JAX's
  ``Precision.HIGHEST``.

The JAX package computes both outside Pallas (an FFT, XLA einsums), so
``torch.fft.rfft`` and plain matmuls are their counterparts.

``mag_scale`` multiplies the window: the half-rate wire analyses audio
decimated by a factor f with a window f times shorter, whose periodic Hann
sums to 1/f of the full one, so f restores the magnitudes exactly.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from some_tpu_torch.audio.mel import hann_window, mel_filterbank


class LogMelSpec:
    """Precomputed constants on ``device`` + ``__call__`` for batched waveforms."""

    def __init__(self, n_mels: int, sample_rate: int, win_length: int, hop_length: int,
                 fmin: float = 0, fmax: float | None = None, clamp: float = 1e-5,
                 method: str = "rfft", device: torch.device | str = "cpu",
                 mag_scale: float = 1.0):
        if method not in ("rfft", "dft"):
            raise ValueError(f"mel_method {method!r}: 'rfft' or 'dft'")
        self.method = method
        self.n_fft = win_length
        self.win_length = win_length
        self.hop_length = hop_length
        self.n_mels = n_mels
        self.clamp = clamp
        window = hann_window(win_length) * float(mag_scale)
        self.window = torch.tensor(window, dtype=torch.float32, device=device)
        basis = mel_filterbank(sample_rate, self.n_fft, n_mels, fmin, fmax)
        used = np.nonzero(basis.any(axis=0))[0]
        self._k_lo, self._k_hi = ((int(used[0]), int(used[-1]) + 1) if len(used)
                                  else (0, self.n_fft // 2 + 1))
        self.basis_trim = torch.tensor(basis[:, self._k_lo:self._k_hi], device=device)
        if method == "dft":
            n = np.arange(self.n_fft)[:, None]
            k = np.arange(self._k_lo, self._k_hi)[None, :]
            angle = 2.0 * np.pi * n * k / self.n_fft
            # the window folded in: frames @ dft_cos == rfft(frames * window).real
            self.dft_cos = torch.tensor((np.cos(angle) * window[:, None]).astype(np.float32),
                                        device=device)
            self.dft_sin = torch.tensor((-np.sin(angle) * window[:, None]).astype(np.float32),
                                        device=device)

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
        if self.method == "dft":
            with _full_f32_matmul():
                re = torch.matmul(frames, self.dft_cos)
                im = torch.matmul(frames, self.dft_sin)
            magnitude = torch.sqrt(re * re + im * im)
        else:
            spec = torch.fft.rfft(frames * self.window, dim=-1)
            magnitude = spec[..., self._k_lo:self._k_hi].abs()
        mel = torch.matmul(magnitude, self.basis_trim.T)
        out = torch.log(torch.clamp(mel, min=self.clamp))
        return out[0] if squeeze else out


@contextlib.contextmanager
def _full_f32_matmul():
    """f32 matmuls without TF32 inside the block, whatever the process set."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
