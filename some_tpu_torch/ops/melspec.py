"""Device log-mel frontend.

Counterpart of ``some_tpu/ops/melspec.py::LogMelSpec``: center pad
(win//2 left, (win+1)//2 right) -> periodic-hann frames -> magnitude
spectrum over the mel filterbank's support (the bins outside it carry zero
weight) -> mel matmul -> log(clamp). Two spectrum methods, as in JAX:

* ``rfft`` (the default): ``torch.fft.rfft`` of the windowed frames;
* ``dft``: the windowed DFT as two real matmuls over the filterbank's
  support, the window folded into the cos and sin matrices (built in f64),
  then ``sqrt(re^2 + im^2)``. Direct summation in f32 loses the quiet bins
  to cancellation: on the CPU the products run in full f32, TF32 off (JAX's
  ``Precision.HIGHEST``), about 1e-2 of log-mel from rfft there (the JAX
  docstring's figure). On the card the f32 products are no less accurate
  than the CPU's against their scale (sum |frame x matrix|), yet their
  errors put the quietest bins several times farther from an f64 log-mel
  than the CPU's do; so there the matrices stay in f64 and the products
  run in f64, which the H100 takes in about the f32 products' time
  (PERF.md; ``chip_smoke.py``'s ``mel_check`` holds it at every bin).

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
            # the window folded in: frames @ dft_cos == rfft(frames * window).real;
            # f64 products on the card, f32 elsewhere (the module docstring)
            dtype = torch.float64 if torch.device(device).type == "cuda" else torch.float32
            self.dft_cos = torch.tensor(np.cos(angle) * window[:, None], dtype=dtype,
                                        device=device)
            self.dft_sin = torch.tensor(-np.sin(angle) * window[:, None], dtype=dtype,
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
            frames = frames.to(self.dft_cos.dtype)
            re = torch.matmul(frames, self.dft_cos)
            im = torch.matmul(frames, self.dft_sin)
            magnitude = torch.sqrt(re * re + im * im).float()
        else:
            spec = torch.fft.rfft(frames * self.window, dim=-1)
            magnitude = spec[..., self._k_lo:self._k_hi].abs()
        mel = torch.matmul(magnitude, self.basis_trim.T)
        out = torch.log(torch.clamp(mel, min=self.clamp))
        return out[0] if squeeze else out


@contextlib.contextmanager
def full_f32():
    """f32 matmuls and cuDNN convolutions and RNNs without TF32 inside the
    block, whatever the process set."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
