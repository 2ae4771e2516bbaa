"""Log-mel frontend, host side (numpy), and the shared filterbank.

Copy of ``some_tpu/audio/mel.py`` (the port imports nothing of the JAX
package): ``mel_filterbank`` and ``hann_window``, which the device log-mel
(``some_tpu_torch/ops/melspec.py``) shares, and the host ``MelSpec`` with
float key shifts (n_fft and the window rescaled by 2**(k/12), the magnitude
cropped or padded back to n_fft//2+1 bins): the pitch-shift augmentation
engine of binarization (reference: modules/rmvpe/spec.py:38-72). The same
numpy calls in the same order as the JAX package's, so the binarized units
are equal bit for bit.
"""
from __future__ import annotations

import numpy as np


def _hz_to_mel_htk(freq):
    return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float | None,
                   htk: bool = True, norm: str = "slaney") -> np.ndarray:
    """Triangular mel filterbank [n_mels, n_fft//2+1].

    Matches librosa.filters.mel(htk=True, norm='slaney') bit-for-bit in
    float64 then cast to float32 — the exact basis the reference registers as
    a buffer (reference: modules/rmvpe/spec.py:22-29).
    """
    if fmax is None:
        fmax = float(sr) / 2
    if not htk:
        raise NotImplementedError("only the HTK mel scale is used by this pipeline")

    n_bins = n_fft // 2 + 1
    fftfreqs = np.linspace(0, float(sr) / 2, n_bins, dtype=np.float64)
    mel_pts = np.linspace(_hz_to_mel_htk(fmin), _hz_to_mel_htk(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_htk(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm[:, None]
    elif norm is not None:
        raise ValueError(f"unsupported norm: {norm}")
    return weights.astype(np.float32)


def hann_window(n: int, dtype=np.float64) -> np.ndarray:
    """Periodic Hann window (torch.hann_window semantics)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n, dtype=dtype) / n)).astype(dtype)


def frame_signal(audio: np.ndarray, frame_length: int, hop: int) -> np.ndarray:
    """[T] -> [num_frames, frame_length] with stride tricks (no copy)."""
    num_frames = 1 + (len(audio) - frame_length) // hop
    return np.lib.stride_tricks.as_strided(
        audio,
        shape=(num_frames, frame_length),
        strides=(audio.strides[0] * hop, audio.strides[0]),
        writeable=False,
    )


class MelSpec:
    """Host log-mel extractor with float key-shift support."""

    def __init__(self, n_mels: int, sample_rate: int, win_length: int, hop_length: int,
                 n_fft: int | None = None, fmin: float = 0, fmax: float | None = None,
                 clamp: float = 1e-5):
        self.n_fft = win_length if n_fft is None else n_fft
        self.win_length = win_length
        self.hop_length = hop_length
        self.sample_rate = sample_rate
        self.n_mels = n_mels
        self.clamp = clamp
        self.basis = mel_filterbank(sample_rate, self.n_fft, n_mels, fmin, fmax)
        self._windows: dict = {}

    def num_frames(self, n_samples: int) -> int:
        # center-padded with win samples total -> exactly n_samples//hop + 1
        return n_samples // self.hop_length + 1

    def __call__(self, audio: np.ndarray, keyshift: float = 0.0, speed: float = 1.0,
                 center: bool = True) -> np.ndarray:
        """[T] float32 -> log-mel [num_frames, n_mels] float32."""
        factor = 2.0 ** (keyshift / 12.0)
        n_fft_new = int(np.round(self.n_fft * factor))
        win_new = int(np.round(self.win_length * factor))
        hop_new = int(np.round(self.hop_length * speed))

        if win_new not in self._windows:
            self._windows[win_new] = hann_window(win_new, dtype=np.float32)
        window = self._windows[win_new]

        x = np.asarray(audio, dtype=np.float32)
        if center:
            x = np.pad(x, (win_new // 2, (win_new + 1) // 2))
        frames = frame_signal(x, n_fft_new, hop_new)
        # win_length == n_fft for every shift in this pipeline; guard anyway.
        if win_new < n_fft_new:
            pad_l = (n_fft_new - win_new) // 2
            w = np.zeros(n_fft_new, dtype=np.float32)
            w[pad_l:pad_l + win_new] = window
        else:
            w = window
        spec = np.fft.rfft(frames * w, n=n_fft_new, axis=-1)
        magnitude = np.abs(spec).astype(np.float32)  # [F, n_fft_new//2+1]

        if keyshift != 0:
            size = self.n_fft // 2 + 1
            if magnitude.shape[1] < size:
                magnitude = np.pad(magnitude, ((0, 0), (0, size - magnitude.shape[1])))
            magnitude = magnitude[:, :size] * (self.win_length / win_new)

        mel = magnitude @ self.basis.T  # [F, n_mels]
        return np.log(np.maximum(mel, self.clamp))


def log_mel_np(audio: np.ndarray, sr: int, n_mels: int = 80, win: int = 2048,
               hop: int = 512, fmin: float = 40, fmax: float = 8000,
               keyshift: float = 0.0) -> np.ndarray:
    """One-shot functional wrapper around MelSpec."""
    return MelSpec(n_mels, sr, win, hop, fmin=fmin, fmax=fmax)(audio, keyshift=keyshift)
