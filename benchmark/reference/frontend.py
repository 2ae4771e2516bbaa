"""Plain reference of the serving front end: silence slicing and the log-mel.

The slicer is the RMS-threshold slicer SOME's inference uses (openvpi's
``slicer2``: -40 dB, chunks of at least 5 s, silences of at least 300 ms,
20 ms hops, at most 1 s of silence kept), written here in numpy. The log-mel
is the HTK-scale, Slaney-normalised filterbank over the magnitude of a
centre-padded, periodic-Hann STFT, ``log(max(mel, 1e-5))``, in float64.
"""
from __future__ import annotations

import numpy as np
import torch


def _rms(y: np.ndarray, frame: int, hop: int) -> np.ndarray:
    pad = frame // 2
    y = np.pad(y.astype(np.float64), (pad, pad))
    csum = np.concatenate(([0.0], np.cumsum(y * y)))
    starts = np.arange(0, len(y) - frame + 1, hop)
    return np.sqrt((csum[starts + frame] - csum[starts]) / frame)


def slice_song(wave: np.ndarray, sr: int, threshold_db: float = -40.0,
               min_length_ms: int = 5000, min_interval_ms: int = 300, hop_ms: int = 20,
               max_sil_kept_ms: int = 1000) -> list:
    """Mono waveform -> [(offset seconds, chunk waveform)]."""
    hop = round(sr * hop_ms / 1000)
    win = min(round(sr * min_interval_ms / 1000), 4 * hop)
    min_length = round(sr * min_length_ms / 1000 / hop)
    min_interval = round(sr * min_interval_ms / 1000 / hop)
    keep = round(sr * max_sil_kept_ms / 1000 / hop)
    threshold = 10 ** (threshold_db / 20.0)
    if (len(wave) + hop - 1) // hop <= min_length:
        return [(0.0, wave)]
    rms = _rms(wave, win, hop)
    tags, start, clip_start = [], None, 0
    for i, level in enumerate(rms):
        if level < threshold:
            if start is None:
                start = i
            continue
        if start is None:
            continue
        leading = start == 0 and i > keep
        middle = i - start >= min_interval and i - clip_start >= min_length
        if not leading and not middle:
            start = None
            continue
        if i - start <= keep:
            pos = start + int(np.argmin(rms[start:i + 1]))
            tags.append((0, pos) if start == 0 else (pos, pos))
            clip_start = pos
        elif i - start <= keep * 2:
            pos = i - keep + int(np.argmin(rms[i - keep:start + keep + 1]))
            pos_l = start + int(np.argmin(rms[start:start + keep + 1]))
            pos_r = i - keep + int(np.argmin(rms[i - keep:i + 1]))
            if start == 0:
                tags.append((0, pos_r))
                clip_start = pos_r
            else:
                tags.append((min(pos_l, pos), max(pos_r, pos)))
                clip_start = max(pos_r, pos)
        else:
            pos_l = start + int(np.argmin(rms[start:start + keep + 1]))
            pos_r = i - keep + int(np.argmin(rms[i - keep:i + 1]))
            tags.append((0, pos_r) if start == 0 else (pos_l, pos_r))
            clip_start = pos_r
        start = None
    n = len(rms)
    if start is not None and n - start >= min_interval:
        end = min(n, start + keep)
        tags.append((start + int(np.argmin(rms[start:end + 1])), n + 1))
    if not tags:
        return [(0.0, wave)]

    def piece(a, b):
        return (a * hop / sr, wave[a * hop:min(len(wave), b * hop)])

    chunks = []
    if tags[0][0] > 0:
        chunks.append(piece(0, tags[0][0]))
    for (_, a), (b, _) in zip(tags[:-1], tags[1:]):
        chunks.append(piece(a, b))
    if tags[-1][1] < n:
        chunks.append(piece(tags[-1][1], n))
    return chunks


def mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """HTK mel scale, Slaney area normalisation: [n_mels, n_fft // 2 + 1]."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    edges = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    lo, mid, hi = edges[:-2, None], edges[1:-1, None], edges[2:, None]
    tri = np.maximum(0.0, np.minimum((freqs - lo) / (mid - lo), (hi - freqs) / (hi - mid)))
    return tri * (2.0 / (hi - lo))


def log_mel(wave: torch.Tensor, sr: int, n_fft: int, hop: int, n_mels: int, fmin: float,
            fmax: float) -> torch.Tensor:
    """[N] waveform -> [N // hop + 1, n_mels] log-mel, in float64."""
    x = F_pad(wave.double(), n_fft)
    window = 0.5 - 0.5 * torch.cos(2 * torch.pi * torch.arange(n_fft, dtype=torch.float64,
                                                                device=x.device) / n_fft)
    frames = x.unfold(0, n_fft, hop) * window
    mag = torch.fft.rfft(frames, dim=-1).abs()
    basis = torch.from_numpy(mel_basis(sr, n_fft, n_mels, fmin, fmax)).to(x.device)
    return torch.log(torch.clamp(mag @ basis.t(), min=1e-5))


def F_pad(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (n_fft // 2, (n_fft + 1) // 2))
