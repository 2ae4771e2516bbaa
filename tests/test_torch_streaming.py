"""The port's live streaming (some_tpu_torch/inference/streaming.py and the
stream CLI) against the JAX package's StreamingTranscriber and against the
port's own offline path.

Both engines take the same weights (tests/test_torch_engine.py's
``variables``, carried across by ``compat/from_jax``) in f32; the port runs
on the CPU. The stream drives the offline silence scan incrementally, so its
chunks are the offline ones and its MIDI equals the offline MIDI byte for
byte; against JAX the notes agree within the tolerances of
tests/test_torch_infer.py.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from some_tpu.inference.streaming import StreamingTranscriber as JaxStreamingTranscriber
from some_tpu_torch.audio.slicer import rms_envelope
from some_tpu_torch.config import save_yaml
from some_tpu_torch.inference.pipeline import transcribe_waveform
from some_tpu_torch.inference.streaming import StreamingTranscriber
from some_tpu_torch.utils.checkpoint import save_checkpoint
from tests.test_inference import synth
from tests.test_torch_engine import assert_notes_match, engines, variables  # noqa: F401
from tests.test_torch_infer import CONFIG, REPO

SR = 44100


@pytest.fixture(scope="module")
def pair(variables):  # noqa: F811
    return engines(variables, transfer_dtype="float32")


def song():
    """Three phrases: the 1 s gap splits (the clip before it is past
    min_length), the 0.8 s gap does not."""
    return np.concatenate([synth(5.5, 440.0, seed=31), np.zeros(SR, np.float32),
                           synth(1.5, 523.25, seed=32), np.zeros(int(0.8 * SR), np.float32),
                           synth(1.2, 330.0, seed=33)])


def noisy_song(seed=60):
    """Gaps of -50 dB noise, not digital zero: near-threshold RMS values make
    the tags depend on the envelope's low-order bits."""
    rng = np.random.default_rng(seed)
    wave = np.concatenate([synth(6.0, 440.0, seed=61), np.zeros(int(1.5 * SR), np.float32),
                           synth(2.0, 523.25, seed=62), np.zeros(SR, np.float32),
                           synth(1.5, 330.0, seed=63)])
    return wave + (10 ** (-50 / 20) * rng.standard_normal(len(wave))).astype(np.float32)


def feed_ragged(st, wave, seed):
    rng = np.random.default_rng(seed)
    pos, events = 0, []
    while pos < len(wave):
        n = int(rng.integers(500, 40000))
        events += st.feed(wave[pos:pos + n])
        pos += n
    return events + st.flush()


class StubEngine:
    """An engine that decodes every chunk to no notes: the host plane alone."""
    config = {"audio_sample_rate": SR}

    def infer(self, waveforms):
        return [{"note_midi": np.zeros(0), "note_dur": np.zeros(0),
                 "note_rest": np.zeros(0, bool)} for _ in waveforms]


def test_events_and_midi_match_jax(pair):
    jax_engine, port = pair
    wave = song()
    want = feed_ragged(JaxStreamingTranscriber(jax_engine), wave, 0)
    st = StreamingTranscriber(port)
    got = feed_ragged(st, wave, 0)
    assert len(got) == len(want) == 2
    assert [e["offset"] for e in got] == [e["offset"] for e in want]
    assert_notes_match([e["segment"] for e in got], [e["segment"] for e in want])
    jax_st = JaxStreamingTranscriber(jax_engine)
    feed_ragged(jax_st, wave, 0)
    assert st.to_midi(tempo=120).serialize() == jax_st.to_midi(tempo=120).serialize()


@pytest.mark.parametrize("seed", [0, 1])
def test_stream_equals_offline_bytes(pair, seed):
    _, port = pair
    wave = song()
    st = StreamingTranscriber(port)
    events = feed_ragged(st, wave, seed)
    assert len(events) == 2
    assert st.to_midi(tempo=120).serialize() == transcribe_waveform(
        port, wave, SR, tempo=120).serialize()


def test_stream_equals_offline_on_noise_floor(pair):
    _, port = pair
    wave = noisy_song()
    st = StreamingTranscriber(port)
    events = feed_ragged(st, wave, 4)
    assert len(events) >= 2
    assert st.to_midi(tempo=120).serialize() == transcribe_waveform(
        port, wave, SR, tempo=120).serialize()


def test_incremental_rms_is_the_offline_envelope_bit_for_bit():
    wave = noisy_song()
    st = StreamingTranscriber(StubEngine())
    recorded = []

    def spy(levels, _orig=st._scanner.feed):
        recorded.extend(levels)
        return _orig(levels)

    st._scanner.feed = spy
    feed_ragged(st, wave, 3)
    np.testing.assert_array_equal(
        np.asarray(recorded), rms_envelope(wave, frame_length=st._win, hop_length=st._hop))


def test_phrases_emit_before_the_stream_ends_and_memory_stays_bounded(pair):
    _, port = pair
    st = StreamingTranscriber(port)
    early = st.feed(synth(6.0, 440.0, seed=40))
    early += st.feed(np.zeros(2 * SR, np.float32))
    early += st.feed(synth(1.0, 392.0, seed=41))
    assert len(early) >= 1, "the first phrase should be emitted mid-stream"
    assert len(st.flush()) >= 1
    with pytest.raises(RuntimeError):
        st.feed(np.zeros(10, np.float32))

    st = StreamingTranscriber(StubEngine())
    phrase = np.concatenate([synth(6.0, 440.0, seed=70), np.zeros(2 * SR, np.float32)])
    for _ in range(6):
        for pos in range(0, len(phrase), SR):
            st.feed(phrase[pos:pos + SR])
    assert len(st._buf) == 6 * len(phrase)
    assert st._buf._n <= len(phrase) + (1 << 16)
    assert st._sq._n <= 2 * st._win + (1 << 16)
    assert len(st._scanner._rms) <= st._scanner.max_sil_kept + (1 << 13)


def test_stream_cli_subprocess(variables, tmp_path):  # noqa: F811
    """``python -m some_tpu_torch.stream --device cpu``: s16le PCM on stdin,
    NDJSON events on stdout, and --midi equal byte for byte to the port's
    offline path on the same samples."""
    from some_tpu_torch.compat.from_jax import jax_params_to_state_dict

    config = dict(CONFIG, transfer_dtype="float32", pl_trainer_precision="32-true")
    save_yaml(config, tmp_path / "config.yaml")
    model = save_checkpoint(tmp_path / "model.pt", jax_params_to_state_dict(
        variables["params"], variables["batch_stats"]))
    pcm = (np.clip(song(), -1, 1) * 32767).astype("<i2")
    midi = tmp_path / "stream.mid"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "some_tpu_torch.stream", "--model", str(model), "--midi",
         str(midi), "--device", "cpu", "--prewarm-buckets", "128", "--chunk-ms", "100"],
        input=pcm.tobytes(), capture_output=True, timeout=600, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr.decode()[-2000:]
    assert b"| ready" in out.stderr
    events = [json.loads(line) for line in out.stdout.decode().splitlines()]
    assert len(events) == 2
    assert set(events[0]) == {"offset_sec", "note_midi", "note_dur_sec", "note_rest"}
    assert [e["offset_sec"] for e in events] == sorted(e["offset_sec"] for e in events)

    from some_tpu_torch.inference.me_infer import MIDIExtractionInference

    engine = MIDIExtractionInference(config, model, dtype=torch.float32, device="cpu")
    want = transcribe_waveform(engine, pcm.astype(np.float32) / 32768.0, SR, tempo=120)
    assert midi.read_bytes() == want.serialize()


def test_stream_cli_refuses_several_devices(tmp_path):
    from some_tpu_torch.stream import main

    with pytest.raises(NotImplementedError, match="--devices 2"):
        main(["--model", str(tmp_path / "model.pt"), "--devices", "2"])
