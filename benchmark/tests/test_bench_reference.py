"""The plain reference against the port's CPU path at a small width: the
slicer's chunks, the log-mel, the model's outputs in float32 (and with
int8 products), and the note decoding."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness.songs import synth
from benchmark.harness.weights import make_weights
from benchmark.reference import decode as RD
from benchmark.reference import frontend as RF
from benchmark.reference import judge as J
from benchmark.reference.model import MidiExtractorRef
from benchmark.tests.conftest import TINY_CONFIG

SR = 44100


@pytest.fixture(scope="module")
def config():
    from some_tpu_torch.config import read_full_config

    from benchmark.run import ROOT

    return dict(read_full_config(ROOT / "configs" / "midi_conformer.yaml"), **TINY_CONFIG)


@pytest.fixture(scope="module")
def wave():
    return synth(7, 40.0, SR, "cpu", phrasing=3).numpy().astype(np.float32) / 32768.0


def test_slicer_matches_the_program(wave):
    from some_tpu_torch.inference.pipeline import slice_waveform

    ours = RF.slice_song(wave, SR)
    theirs = slice_waveform(wave, SR)
    assert len(ours) > 2
    assert [o for o, _ in ours] == [c["offset"] for c in theirs]
    assert all(np.array_equal(a, c["waveform"]) for (_, a), c in zip(ours, theirs))


def test_log_mel_matches_the_program(wave, config):
    from some_tpu_torch.ops.melspec import LogMelSpec

    piece = wave[: SR * 6]
    ours = RF.log_mel(torch.from_numpy(piece), SR, 2048, 512, 80, 40, 8000)
    theirs = LogMelSpec(80, SR, 2048, 512, 40, 8000)(torch.from_numpy(piece))
    assert ours.shape == theirs.shape
    loud = ours > np.log(1e-3)
    assert float((ours.float() - theirs).abs()[loud].max()) < 1e-3


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_model_matches_the_program(config, quant):
    from some_tpu_torch.nn.model import build_midi_extractor
    from some_tpu_torch.ops.quant import quantize_params

    cfg = dict(config, quantize=quant)
    weights = make_weights(cfg, 11, "cpu")
    model = build_midi_extractor(cfg).eval()
    model.load_state_dict(weights)
    if quant == "int8":
        quantize_params(model)
    a = cfg["midi_extractor_args"]
    ref = MidiExtractorRef(weights, a["lay"], a["attention_heads"], a["attention_heads_dim"],
                           quant=None if quant == "none" else quant)
    units = torch.randn(2, 150, 80, generator=torch.Generator().manual_seed(3))
    mask = torch.ones(2, 150, dtype=torch.bool)
    mask[1, 100:] = False
    with torch.no_grad():
        want_logits, want_bounds = model(units, mask=mask)
        got_logits, got_bounds = ref.forward(units, mask)
    real = mask[..., None].expand_as(want_logits)
    tol = 1e-4 if quant == "none" else 2e-2
    assert float((got_logits - want_logits)[real].abs().max()) < tol
    assert float((got_bounds - want_bounds)[mask].abs().max()) < tol


def test_decode_matches_the_program(config):
    from some_tpu_torch.ops.decode import (
        decode_bounds_to_alignment, decode_gaussian_blurred_probs, decode_note_sequence,
    )

    gen = torch.Generator().manual_seed(5)
    probs = torch.rand(1, 300, 128, generator=gen) ** 4
    bounds = torch.rand(1, 300, generator=gen) ** 3
    f2n = decode_bounds_to_alignment(bounds)
    midi, rest = decode_gaussian_blurred_probs(probs, 0, 127, 1.0, 0.1)
    note_midi, note_dur, note_mask = decode_note_sequence(f2n, midi, ~rest)
    n = int(f2n.max())
    pitch, frames, ref_rest = RD.decode_notes(probs[0].double().numpy(),
                                              bounds[0].double().numpy(), 0, 127, 1.0, 0.1)
    assert len(frames) == n
    assert np.array_equal(frames, note_dur[0, :n].numpy())
    assert np.array_equal(ref_rest, ~note_mask[0, :n].numpy())
    assert np.allclose(pitch, note_midi[0, :n].double().numpy(), atol=1e-4)


def test_judge_reads_a_served_reply_exactly(wave, config):
    """The reference's own notes, as a reply, judge to zero; the same notes a
    semitone up are all off."""
    a = config["midi_extractor_args"]
    ref_model = MidiExtractorRef(make_weights(config, 12, "cpu"), a["lay"],
                                 a["attention_heads"], a["attention_heads_dim"])
    with torch.no_grad():
        ref = J.reference_chunks(wave, config, ref_model, "cpu")
    reply = J.as_reply(ref, config)
    assert J.numbers([J.judge_reply(reply, ref, config)]) == {
        "chunks_off": 0, "pitch_off_share": 0.0, "note_count_dev": 0.0}
    for seg in reply["segments"]:
        seg["note_midi"] = [p + 1.0 for p in seg["note_midi"]]
    assert J.numbers([J.judge_reply(reply, ref, config)])["pitch_off_share"] == 1.0
