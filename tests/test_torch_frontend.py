"""Host plane and frontend of the PyTorch port against the JAX package:
config reader, mel filterbank and window, LogMelSpec, the wire, the silence
slicer and the MIDI writer, on the same numpy inputs."""
import pathlib

import numpy as np
import pytest
import torch
import yaml

import some_tpu.config as jax_config
from some_tpu.audio.mel import hann_window as jax_hann, mel_filterbank as jax_fb
from some_tpu.audio.slicer import SilenceSlicer as JaxSlicer
from some_tpu.audio.slicer import rms_envelope as jax_rms_envelope
from some_tpu.audio.wire import decode_wire_device as jax_decode_wire
from some_tpu.audio.wire import encode_wire as jax_encode_wire
from some_tpu.ops.melspec import LogMelSpec as JaxLogMelSpec
from some_tpu.utils.midi_file import build_midi_file as jax_build_midi
from some_tpu_torch import config as port_config
from some_tpu_torch.audio.mel import hann_window, mel_filterbank
from some_tpu_torch.audio.slicer import SilenceSlicer
from some_tpu_torch.audio.wire import decode_wire_device, encode_wire, silence_buffer
from some_tpu_torch.ops.melspec import LogMelSpec
from some_tpu_torch.utils.midi_file import build_midi_file

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))
SR = 44100


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_reader_matches_yaml_and_cascade(path):
    assert port_config.parse_yaml(path.read_text()) == yaml.safe_load(path.read_text())
    jax_config._CONFIG_CACHE.clear()  # its cache shares nested dicts between files
    full = port_config.read_full_config(path)
    assert full == jax_config.read_full_config(path)
    # what the port writes, both readers read back unchanged; and it reads
    # what PyYAML writes
    assert port_config.parse_yaml(port_config.dump_yaml(full)) == full
    assert yaml.safe_load(port_config.dump_yaml(full)) == full
    assert port_config.parse_yaml(yaml.safe_dump(full)) == full


def test_yaml_scalars_resolve_as_pyyaml():
    text = "\n".join([
        "a: 0.00001", "b: 1.0e-05", "c: true", "d: false", "e: null", "f: '#not a comment'",
        "g: [1, -2.5, x.y, null]  # comment", "h: {}", "i:", "j: 'it''s 32-true'",
        "k: data/some_ds/binary", "l: []", "m:", "- 1", "- two", "n:", "  o: 3", "  p:",
        "    - [a, b]",
        # plain scalars PyYAML reads as strings or as its special floats and
        # null, which safe_dump writes into a trainer's config.yaml
        "q: 1e-5", "r: ~", "s: -.inf", "t: x y", "u: 08", "v: /data/some ds/binary",
        "w: -x", "x: a:b", "y: x#y", "z: .inf",
    ])
    assert port_config.parse_yaml(text) == yaml.safe_load(text)
    # forms outside the subset, which PyYAML reads as another type than a
    # string (or that no config uses), raise
    for bad in ("a: yes", "a: Off", "a: 0x1F", "a: 1_000", "a: 0o17x: 1", "a: 2001-12-14",
                "a: 1:20", 'a: "q"', "a:\n  - b: 1\n", "a: {b: 1}", "a: - - 1"):
        with pytest.raises(ValueError):
            port_config.parse_yaml(bad)


def test_filterbank_and_window():
    np.testing.assert_allclose(mel_filterbank(SR, 2048, 80, 40, 8000),
                               jax_fb(SR, 2048, 80, 40, 8000), atol=1e-7, rtol=0)
    np.testing.assert_allclose(hann_window(2048), jax_hann(2048), atol=1e-7, rtol=0)


@pytest.mark.parametrize("n_samples", [44100, 12345])
def test_log_mel_matches_jax(n_samples):
    rng = np.random.default_rng(n_samples)
    t = np.arange(n_samples) / SR
    # the signal of tests/test_mel.py: the noise floor keeps every mel bin
    # well above the clamp, where log() would magnify f32 FFT rounding
    noise = 0.01 * rng.standard_normal((2, n_samples))
    audio = (np.stack([0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 880 * t),
                       0.3 * np.sin(2 * np.pi * 150 * t)]) + noise).astype(np.float32)
    want = np.asarray(JaxLogMelSpec(80, SR, 2048, 512, fmin=40, fmax=8000)(audio))
    mel = LogMelSpec(80, SR, 2048, 512, fmin=40, fmax=8000)
    got = mel(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (2, mel.num_frames(n_samples), 80)
    print(f"parity log-mel: max|d| {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(mel(torch.from_numpy(audio[1])).numpy(), got[1], atol=1e-6)
    # the dft method (the window folded into cos/sin matrices, full-f32
    # products): against JAX's dft at the rfft's tolerance, and within the
    # 1e-2 the JAX docstring gives for dft against rfft
    for mag_scale in (1.0, 2.0):
        want = np.asarray(JaxLogMelSpec(80, SR, 2048, 512, fmin=40, fmax=8000, method="dft",
                                        mag_scale=mag_scale)(audio))
        dft = LogMelSpec(80, SR, 2048, 512, fmin=40, fmax=8000, method="dft",
                         mag_scale=mag_scale)(torch.from_numpy(audio)).numpy()
        print(f"parity dft log-mel (mag_scale {mag_scale}): max|d| {np.abs(dft - want).max():.3g}")
        np.testing.assert_allclose(dft, want, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(
        LogMelSpec(80, SR, 2048, 512, fmin=40, fmax=8000, method="dft")(torch.from_numpy(audio))
        .numpy(), got, atol=1e-2, rtol=0)
    with pytest.raises(ValueError, match="mel_method"):
        LogMelSpec(80, SR, 2048, 512, method="stft")


@pytest.mark.parametrize("wire", ["int16", "float32"])
def test_wire_encode_and_decode_exact(wire):
    rng = np.random.default_rng(1)
    wave = np.clip(rng.standard_normal((2, 1000)) * 0.5, -1.2, 1.2).astype(np.float32)
    enc = encode_wire(wave, wire)
    np.testing.assert_array_equal(enc, jax_encode_wire(wave, wire))
    want = np.asarray(jax_decode_wire(enc, wire=wire, n_samples=999))
    got = decode_wire_device(torch.from_numpy(enc), wire, n_samples=999).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    silence = silence_buffer(wire, 3, 10)
    assert decode_wire_device(torch.from_numpy(silence), wire).abs().max() == 0


def test_unported_wires_raise():
    """Every wire of the JAX package is ported; a name outside them raises,
    and so does a wire tensor of another dtype than its wire's."""
    with pytest.raises(ValueError, match="unknown transfer_dtype"):
        encode_wire(np.zeros(4, np.float32), "mulaw16")
    with pytest.raises(ValueError, match="unknown transfer_dtype"):
        decode_wire_device(torch.zeros(4, dtype=torch.uint8), "mulaw16")
    with pytest.raises(TypeError, match="must be torch.int16"):
        decode_wire_device(torch.zeros(4, dtype=torch.uint8), "int16")


def _song(seed):
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(5):
        n = int(SR * rng.uniform(1.0, 6.0))
        parts.append(0.4 * np.sin(2 * np.pi * rng.uniform(150, 600) * np.arange(n) / SR))
        parts.append(np.zeros(int(SR * rng.uniform(0.1, 1.5))))
    return np.concatenate(parts).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slicer_matches_jax(seed):
    wave = _song(seed)
    jax_slicer = JaxSlicer(sr=SR, max_sil_kept=1000)
    # the JAX package's Python scan (its slice() may take the native one)
    rms = jax_rms_envelope(wave, frame_length=jax_slicer.win_size,
                           hop_length=jax_slicer.hop_size)
    want_chunks = jax_slicer._apply_tags(wave, jax_slicer._scan_python(rms), rms.shape[0])
    got_chunks = SilenceSlicer(sr=SR, max_sil_kept=1000).slice(wave)
    assert len(got_chunks) == len(want_chunks) > 1
    for a, b in zip(got_chunks, want_chunks):
        assert a["offset"] == b["offset"]
        np.testing.assert_array_equal(a["waveform"], b["waveform"])


def test_midi_file_bytes_match_jax():
    rng = np.random.default_rng(2)
    segments = [{"note_midi": rng.uniform(40, 80, n).astype(np.float32),
                 "note_dur": rng.uniform(0.05, 0.5, n),
                 "note_rest": rng.random(n) < 0.3} for n in (7, 0, 12)]
    offsets = [0.0, 3.1, 4.25]
    assert (build_midi_file(offsets, segments, tempo=97).serialize()
            == jax_build_midi(offsets, segments, tempo=97).serialize())
