"""Preprocessing of the port on the card against its CPU versions: RMVPE
(probabilities, f0 and voicing), ContentVec (full HuBERT-base width), their
true-f32 pin whatever TF32 setting the process made, and the dft log-mel's
quiet bins. Imports nothing of JAX, so it runs on a machine with a card and
no JAX:

    python -m pytest --noconftest tests/test_torch_binarize_gpu.py -q -m gpu

Every test here needs the card and skips without one.
"""
import numpy as np
import pytest
import torch

from some_tpu_torch.nn import contentvec as C
from some_tpu_torch.nn import rmvpe as R

pytestmark = pytest.mark.gpu
SR = 16000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def sung(seconds, hz, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    vib = 1 + 0.004 * np.sin(2 * np.pi * 5.5 * t)
    return (0.4 * np.sin(2 * np.pi * hz * np.cumsum(vib) / SR)
            + 0.003 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def rmvpe_pair(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = tmp_path_factory.mktemp("rmvpe") / "model.pt"
    torch.save({"model": R.random_state_dict(17)}, path)
    return R.RMVPE(path, device="cuda"), R.RMVPE(path, device="cpu")


def test_rmvpe_card_matches_cpu(rmvpe_pair):
    """Packed f0_batch of two songs on the card against the CPU: the
    probabilities to atol 5e-5 / rtol 1e-4, voicing exactly but on frames
    within 1e-4 of the 0.03 threshold, f0 within 0.01 cent where both are
    voiced."""
    card, cpu = rmvpe_pair
    waves = [sung(3.0, 220.0, 1), sung(1.3, 330.0, 2)]
    mels = [cpu.audio_to_mel(w, SR) for w in waves]
    for got, want in zip(card.mel2hidden_batch(mels), cpu.mel2hidden_batch(mels)):
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)
    for w, m, got, want in zip(waves, mels, card.f0_batch(waves, SR), cpu.f0_batch(waves, SR)):
        peak = cpu.mel2hidden(m)[0].max(axis=1)
        flip = (got > 0) != (want > 0)
        assert not (flip & (np.abs(peak - 0.03) > 1e-4)).any()
        both = (got > 0) & (want > 0)
        assert 1200 * np.abs(np.log2(got[both] / want[both])).max() < 0.01


def test_forwards_pin_true_f32(cuda, rmvpe_pair):
    """With TF32 allowed in cuDNN and cuBLAS, the RMVPE and ContentVec
    forwards stay within f32 noise (1e-6 + 1e-5 |want|; TF32's 10-bit
    mantissa would move them by about 1e-3) of their outputs with it off,
    and leave the process's settings as they were. The unpinned modules'
    difference under TF32 is printed beside it."""
    card, _ = rmvpe_pair
    mel = torch.from_numpy(card.audio_to_mel(sung(1.0, 262.0, 3), SR)[None, :96]).to(cuda)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        hubert = C.HubertEncoder(output_layer=2).to(cuda).eval()
    wave = torch.from_numpy(sung(1.0, 262.0, 4)[None]).to(cuda)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    outs = {}
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            with torch.no_grad():
                outs[tf32] = (card.model(mel, t_valid=96), hubert(wave),
                              card.model.unet(mel.unsqueeze(1)), hubert.feature_extractor(wave))
            assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) \
                == (tf32, tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    for a, b in zip(outs[False][:2], outs[True][:2]):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=1e-5)
    print("pinned forwards, TF32 on vs off:",
          [float((b - a).abs().max()) for a, b in zip(outs[False][:2], outs[True][:2])],
          "unpinned U-Net and feature extractor:",
          [float((b - a).abs().max()) for a, b in zip(outs[False][2:], outs[True][2:])])


def test_contentvec_full_width_card_matches_cpu(cuda):
    """HuBERT-base at full width (768, 12 heads, FFN 3072; the 9 layers up
    to output layer 9) on seeded random weights: the card against the CPU,
    and the bucketed, masked forward against the unpadded one."""
    encoder = C.ContentVecEncoder(None, device="cuda", seed=5)
    cpu = C.ContentVecEncoder(None, device="cpu", seed=5)
    wave = sung(2.0, 196.0, 6)
    got, want = encoder(wave, sample_rate=SR), cpu(wave, sample_rate=SR)
    assert got.shape == (C.conv_frames(len(wave)), 768)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        unpadded = encoder.model(torch.from_numpy(wave[None]).to(cuda))[0].cpu().numpy()
    np.testing.assert_allclose(got, unpadded, atol=1e-4, rtol=1e-4)


def test_dft_log_mel_quiet_bins(cuda):
    """The dft log-mel on the card keeps f64 matrices and is, at every bin,
    no farther from an f64 log-mel than the CPU's dft is."""
    from chip_smoke import f64_log_mel, make_song

    from some_tpu_torch.ops.melspec import LogMelSpec

    config = {"win_size": 2048, "hop_size": 512, "audio_sample_rate": 44100,
              "units_dim": 80, "fmin": 40, "fmax": 8000}
    wave = np.round(make_song(1000, phrases=2)[None] * 32767) / 32767
    wave = wave.astype(np.float32)
    args = (80, 44100, 2048, 512)
    kwargs = dict(fmin=40, fmax=8000, method="dft")
    card = LogMelSpec(*args, device="cuda", **kwargs)
    assert card.dft_cos.dtype == torch.float64
    got = card(torch.from_numpy(wave).to(cuda)).cpu().numpy()
    cpu = LogMelSpec(*args, device="cpu", **kwargs)(torch.from_numpy(wave)).numpy()
    ref = f64_log_mel(wave, config)
    assert np.abs(got - ref).max() <= np.abs(cpu - ref).max()
