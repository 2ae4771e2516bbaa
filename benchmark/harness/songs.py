"""Seeded sung-like songs, synthesised on the device, as 16-bit mono WAV bytes.

A song is phrases of 2-12 s parted by 0.3-2 s of silence. A phrase is a run
of notes of 0.15-0.8 s whose pitch walks by up to four semitones around a
register (MIDI 48-72), with 40 ms glides between notes, 5.5 Hz vibrato of
+-0.3 semitone after a note's first 200 ms, six harmonics falling as
1/h^1.5, a 40 ms attack and release and a little breath noise. The song
lengths are one fixed set for every seed (quantiles of a log-normal law
clipped to the mix's range), and so is each song's phrasing (its phrases'
and silences' lengths, drawn from the song's place in that set): every
seed offers the same audio in the same chunks to the slicer. The seed
orders the songs and draws their notes, registers and breath noise.
"""
from __future__ import annotations

import io
import math
import struct

import numpy as np
import torch


def song_lengths(n: int, median_s: float, sigma: float, lo_s: float, hi_s: float) -> list:
    """n lengths in seconds: the quantiles (i + 0.5) / n of a log-normal law."""
    from statistics import NormalDist

    z = [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    return [min(hi_s, max(lo_s, median_s * math.exp(sigma * v))) for v in z]


def _plan(phrasing: np.random.Generator, rng: np.random.Generator, seconds: float, sr: int):
    """Host plan of one song: its notes as (start sample, end sample, MIDI
    pitch) and its phrases as (start sample, end sample); the phrase and
    silence lengths from ``phrasing``, the notes from ``rng``."""
    notes, phrases = [], []
    t = float(phrasing.uniform(0.2, 1.0))
    register = float(rng.uniform(52, 68))
    while True:
        length = float(phrasing.uniform(2.0, 12.0))
        gap = float(phrasing.uniform(0.3, 2.0))
        if t + length > seconds - 0.2:
            break
        start, end = t, t + length
        phrases.append((int(start * sr), int(end * sr)))
        pitch = register + float(rng.integers(-5, 6))
        while t < end:
            dur = min(float(rng.uniform(0.15, 0.8)), end - t)
            notes.append((int(t * sr), int((t + dur) * sr), pitch))
            pitch = float(np.clip(pitch + rng.integers(-4, 5), 48, 72))
            t += dur
        t = end + gap
    return notes, phrases


def synth(seed: int, seconds: float, sr: int, device, phrasing: int = 0) -> torch.Tensor:
    """One song as int16 samples on ``device``: its phrasing drawn from
    ``phrasing``, everything else from ``seed``."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    notes, phrases = _plan(np.random.default_rng([phrasing, 5]), rng, seconds, sr)
    f0 = torch.zeros(n, dtype=torch.float64, device=device)
    env = torch.zeros(n, dtype=torch.float64, device=device)
    if notes:
        starts = torch.tensor([a for a, _, _ in notes], device=device)
        ends = torch.tensor([b for _, b, _ in notes], device=device)
        pitches = torch.tensor([p for _, _, p in notes], dtype=torch.float64, device=device)
        lengths = ends - starts
        idx = torch.repeat_interleave(torch.arange(len(notes), device=device), lengths)
        pos = torch.cat([torch.arange(int(m), device=device) for m in lengths.tolist()])
        prev = torch.cat([pitches[:1], pitches[:-1]])
        glide = torch.clamp(pos.double() / (0.04 * sr), max=1.0)
        pitch = prev[idx] + (pitches[idx] - prev[idx]) * glide
        vib_on = (pos.double() > 0.2 * sr).double()
        tt = torch.arange(len(idx), device=device, dtype=torch.float64) / sr
        pitch = pitch + 0.3 * vib_on * torch.sin(2 * math.pi * 5.5 * tt)
        cover = torch.cat([torch.arange(int(a), int(b), device=device) for a, b, _ in notes])
        f0[cover] = 440.0 * torch.pow(2.0, (pitch - 69.0) / 12.0)
    ramp = int(0.04 * sr)
    for a, b in phrases:
        m = b - a
        e = torch.ones(m, dtype=torch.float64, device=device)
        r = min(ramp, m // 2)
        e[:r] = torch.linspace(0, 1, r, dtype=torch.float64, device=device)
        e[m - r:] = torch.linspace(1, 0, r, dtype=torch.float64, device=device)
        env[a:b] = e
    phase = torch.cumsum(2 * math.pi * f0 / sr, dim=0)
    wave = sum(torch.sin(h * phase) / h ** 1.5 for h in range(1, 7))
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    breath = torch.randn(n, generator=gen, device=device, dtype=torch.float64)
    wave = env * (0.3 * wave + 0.01 * breath)
    return torch.clamp(torch.round(wave * 32768.0), -32768, 32767).to(torch.int16)


def wav_bytes(samples: np.ndarray, sr: int) -> bytes:
    """int16 mono samples -> a RIFF WAVE file's bytes."""
    data = np.ascontiguousarray(samples, dtype="<i2").tobytes()
    out = io.BytesIO()
    out.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
    out.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, 2 * sr, 2, 16))
    out.write(b"data" + struct.pack("<I", len(data)))
    out.write(data)
    return out.getvalue()


def song_pool(seed: int, mix: dict, sr: int, device) -> list:
    """The mix's songs for ``seed``: [(int16 samples on the host, seconds)],
    in the seed's order."""
    lengths = song_lengths(mix["songs"], mix["song_median_s"], mix["song_sigma"],
                           mix["song_min_s"], mix["song_max_s"])
    order = np.random.default_rng([int(seed), 1]).permutation(len(lengths))
    out = []
    for i, k in enumerate(order):
        samples = synth(int(seed) * 1000 + i, lengths[k], sr, device, phrasing=int(k))
        samples = samples.cpu().numpy()
        out.append((samples, len(samples) / sr))
    return out
