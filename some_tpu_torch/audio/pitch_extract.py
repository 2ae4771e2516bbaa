"""Host-plane pitch extractors for binarization.

Port of ``some_tpu/audio/pitch_extract.py``: the numpy extractors are
copies; ``pe: rmvpe`` runs the port's RMVPE (``some_tpu_torch/nn/rmvpe.py``)
on ``device`` (the card unless the caller passes ``"cpu"``). The reference
offers parselmouth (Praat autocorrelation) or RMVPE
(reference: preprocessing/me_binarizer.py:175-199). Here:

* ``pe: parselmouth`` — used if the optional parselmouth wheel imports;
  gated.
* ``pe: rmvpe``       — RMVPE as an ``nn.Module``, needs the published model.pt.
* ``pe: yin``         — self-contained numpy YIN (de Cheveigné & Kawahara
  2002) with CMNDF thresholding + parabolic interpolation; the out-of-the-box
  default when neither is available. Note the extracted pitch
  curve is an auxiliary dataset attribute (the backbone ignores its f0 input
  — reference: modules/conform/Gconform.py:119), used for validation plots,
  so extractor choice does not affect model quality.

All extractors return (f0[length], uv[length]) at the mel hop timestep.
"""
from __future__ import annotations

import numpy as np

from some_tpu_torch.utils.pitch import interp_f0


def pad_curve_frames(frames: np.ndarray, hop_size: int, n_samples: int,
                     n_expect: int) -> np.ndarray:
    """Center-align an extractor's frame grid onto the mel grid
    (reference: binarizer_utils.py:97-107)."""
    n_frames = frames.shape[0]
    lpad = (int(n_samples // hop_size) - n_frames + 1) // 2
    rpad = n_expect - n_frames - lpad
    if rpad < 0:
        frames = frames[:rpad]
        rpad = 0
    if lpad > 0 or rpad > 0:
        frames = np.pad(frames, (lpad, rpad), mode="constant",
                        constant_values=(frames[0], frames[-1]))
    return frames


def yin_pitch(waveform: np.ndarray, sample_rate: int, hop_size: int, length: int,
              f0_min: float = 65.0, f0_max: float = 800.0,
              threshold: float = 0.1, interp_uv: bool = False):
    """Vectorized YIN over all frames at once (difference fn via FFT)."""
    x = np.asarray(waveform, dtype=np.float64)
    tau_max = int(sample_rate / f0_min) + 1
    tau_min = max(int(sample_rate / f0_max), 2)
    win = 2 * tau_max
    pad = win // 2
    x_p = np.pad(x, (pad, pad))
    n_frames = len(x) // hop_size + 1
    starts = np.arange(n_frames) * hop_size
    valid = starts + win <= len(x_p)
    starts = starts[valid]

    frames = np.lib.stride_tricks.as_strided(
        x_p, shape=(len(starts), win),
        strides=(x_p.strides[0] * hop_size, x_p.strides[0]), writeable=False)

    # difference function d(tau) = sum_{j<W} (x[j] - x[j+tau])^2
    #                  = e0 + e_tau - 2 * corr(tau), corr via FFT
    W = win // 2
    fsize = 1 << int(np.ceil(np.log2(win + W)))
    fft_full = np.fft.rfft(frames, fsize)
    fft_head = np.fft.rfft(frames[:, :W], fsize)
    # corr[tau] = sum_{j=0}^{W-1} x[j] * x[j+tau]  (template restricted to W)
    corr = np.fft.irfft(fft_full * np.conj(fft_head), fsize)[:, :W + 1]
    sq = frames ** 2
    csum = np.concatenate(
        [np.zeros((len(starts), 1)), np.cumsum(sq, axis=1)], axis=1)
    energy0 = csum[:, W:W + 1] - csum[:, :1]          # energy of x[0:W]
    energy_tau = csum[:, W:2 * W + 1] - csum[:, :W + 1]  # energy of x[tau:tau+W]
    diff = np.maximum(energy0 + energy_tau - 2 * corr, 0.0)  # [F, W+1]

    # cumulative mean normalized difference
    tau = np.arange(1, W + 1)
    cmndf = np.ones((len(starts), W + 1))
    running = np.cumsum(diff[:, 1:], axis=1)
    cmndf[:, 1:] = diff[:, 1:] * tau / np.maximum(running, 1e-12)

    lo, hi = tau_min, min(tau_max, W)
    seg = cmndf[:, lo:hi]
    below = seg < threshold
    first_below = np.where(below.any(axis=1), below.argmax(axis=1),
                           seg.argmin(axis=1))
    voiced = below.any(axis=1) | (seg.min(axis=1) < 0.3)
    # energy gate: silent frames are never voiced
    voiced &= energy0[:, 0] > 1e-6 * W
    tau_est = first_below + lo

    # refine: local minimum then parabolic interpolation
    f0 = np.zeros(len(starts))
    for i in range(len(starts)):
        if not voiced[i]:
            continue
        t = int(tau_est[i])
        while t + 1 < hi and cmndf[i, t + 1] < cmndf[i, t]:
            t += 1
        if lo < t < hi - 1:
            a, b, c = cmndf[i, t - 1], cmndf[i, t], cmndf[i, t + 1]
            denom = a - 2 * b + c
            shift = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
            shift = np.clip(shift, -1, 1)
        else:
            shift = 0.0
        f0[i] = sample_rate / (t + shift)

    f0 = pad_curve_frames(f0.astype(np.float32), hop_size, len(x), length)
    uv = f0 == 0
    if interp_uv and (~uv).any():
        f0, uv = interp_f0(f0, uv)
    elif interp_uv and uv.all():
        # degenerate all-unvoiced input: avoid hz_to_midi(-inf) downstream
        f0 = np.full(length, 150.0, dtype=np.float32)
    return f0, uv


def parselmouth_pitch(waveform: np.ndarray, sample_rate: int, hop_size: int,
                      length: int, interp_uv: bool = False):
    """Praat autocorrelation pitch (reference: binarizer_utils.py:110-125).
    Requires the optional parselmouth wheel."""
    import parselmouth  # gated optional dependency

    time_step = hop_size / sample_rate
    f0 = parselmouth.Sound(
        waveform, sampling_frequency=sample_rate
    ).to_pitch_ac(
        time_step=time_step, voicing_threshold=0.6,
        pitch_floor=65, pitch_ceiling=800,
    ).selected_array["frequency"].astype(np.float32)
    f0 = pad_curve_frames(f0, hop_size, waveform.shape[0], length)
    uv = f0 == 0
    if interp_uv:
        f0, uv = interp_f0(f0, uv)
    return f0, uv


def extract_pitch(algorithm: str, waveform: np.ndarray, sample_rate: int,
                  hop_size: int, length: int, interp_uv: bool = True,
                  rmvpe_ckpt: str | None = None, device="cuda"):
    """Dispatch by config 'pe' key, as the JAX package does: parselmouth
    falls back to YIN when it does not import, RMVPE when its checkpoint
    file is missing. Nothing else falls back: an error of the card, or of
    building or launching on it, propagates."""
    if algorithm == "parselmouth":
        try:
            return parselmouth_pitch(waveform, sample_rate, hop_size, length,
                                     interp_uv=interp_uv)
        except ImportError:
            algorithm = "yin"
    if algorithm == "rmvpe":
        from some_tpu_torch.nn.rmvpe import RMVPE
        try:
            rmvpe = RMVPE.cached(rmvpe_ckpt, device=device)
        except FileNotFoundError as exc:
            print(f"| rmvpe unavailable ({exc}); falling back to yin")
            algorithm = "yin"
        else:
            return rmvpe.get_pitch(waveform, sample_rate=sample_rate,
                                   hop_size=hop_size, length=length,
                                   interp_uv=interp_uv)
    if algorithm == "yin":
        return yin_pitch(waveform, sample_rate, hop_size, length,
                         interp_uv=interp_uv)
    raise NotImplementedError(f"Invalid pitch extractor: {algorithm}")
