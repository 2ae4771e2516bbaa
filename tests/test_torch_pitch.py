"""The port's host frontend for binarization against the JAX package, bit
for bit: the host MelSpec at float key shifts (the augmentation engine, so
the binarized units compare exactly), YIN, the parselmouth dispatch (which
falls back to YIN where parselmouth does not import) and the f0 helpers of
utils/pitch."""
import numpy as np
import pytest

from some_tpu.audio.mel import MelSpec as JaxMelSpec
from some_tpu.audio.mel import log_mel_np as jax_log_mel_np
from some_tpu.audio.pitch_extract import extract_pitch as jax_extract_pitch
from some_tpu.audio.pitch_extract import pad_curve_frames as jax_pad_curve_frames
from some_tpu.audio.pitch_extract import yin_pitch as jax_yin
from some_tpu.utils import pitch as jax_pitch
from some_tpu_torch.audio.mel import MelSpec, log_mel_np
from some_tpu_torch.audio.pitch_extract import extract_pitch, pad_curve_frames, yin_pitch
from some_tpu_torch.utils import pitch

SR = 44100


@pytest.mark.parametrize("keyshift", [0.0, 0.37, -0.37, 3.0, -3.0, 12.0])
def test_host_melspec_bit_for_bit(keyshift):
    rng = np.random.default_rng(int(abs(keyshift) * 100))
    audio = (0.3 * rng.standard_normal(SR // 2)).astype(np.float32)
    got = MelSpec(80, SR, 2048, 512, fmin=40, fmax=8000)(audio, keyshift=keyshift)
    want = JaxMelSpec(80, SR, 2048, 512, fmin=40, fmax=8000)(audio, keyshift=keyshift)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_log_mel_np_and_rmvpe_geometry():
    audio = np.random.default_rng(1).standard_normal(16000).astype(np.float32) * 0.2
    np.testing.assert_array_equal(log_mel_np(audio, 16000, n_mels=128, win=1024, hop=160,
                                             fmin=30, keyshift=0.5),
                                  jax_log_mel_np(audio, 16000, n_mels=128, win=1024, hop=160,
                                                 fmin=30, keyshift=0.5))


def test_pad_curve_frames_bit_for_bit():
    frames = np.arange(1, 40, dtype=np.float32)
    for n_expect in (30, 39, 50):
        np.testing.assert_array_equal(pad_curve_frames(frames, 512, 39 * 512, n_expect),
                                      jax_pad_curve_frames(frames, 512, 39 * 512, n_expect))


def test_yin_and_pitch_helpers_bit_for_bit():
    rng = np.random.default_rng(4)
    t = np.arange(SR) / SR
    wave = (0.4 * np.sin(2 * np.pi * 220 * t) * (t < 0.6)
            + 0.002 * rng.standard_normal(SR)).astype(np.float32)
    length = SR // 512 + 1
    for interp_uv in (False, True):
        got, want = yin_pitch(wave, SR, 512, length, interp_uv=interp_uv), \
            jax_yin(wave, SR, 512, length, interp_uv=interp_uv)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(
        extract_pitch("parselmouth", wave, SR, 512, length, device="cpu")[0],
        jax_extract_pitch("parselmouth", wave, SR, 512, length)[0])
    f0 = np.abs(rng.normal(200, 80, 300)).astype(np.float32)
    f0[rng.random(300) < 0.3] = 0
    np.testing.assert_array_equal(pitch.f0_to_coarse(f0), jax_pitch.f0_to_coarse(f0))
    for a, b in zip(pitch.interp_f0(f0.copy()), jax_pitch.interp_f0(f0.copy())):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pitch.resample_align_curve(f0, 0.01, 512 / SR, 400),
                                  jax_pitch.resample_align_curve(f0, 0.01, 512 / SR, 400))
    np.testing.assert_array_equal(pitch.denorm_f0(pitch.norm_f0(f0.copy()), f0 == 0),
                                  jax_pitch.denorm_f0(jax_pitch.norm_f0(f0.copy()), f0 == 0))
