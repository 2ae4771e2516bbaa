"""The port's batch_infer (some_tpu_torch/batch_infer.py) against the JAX
package's batch_infer.py: every helper on seeded inputs, and the CLI end to
end on tests/test_batch_infer_cli.py's dataset and checkpoint, in f32, in
both --round_midi modes (the port with --device cpu; note_seq equal,
note_dur within 1e-6 of the JAX CSV)."""
import copy
import csv
import shutil

import numpy as np
import pytest
import yaml

import batch_infer as jax_bi
from some_tpu_torch import batch_infer as port_bi
from tests.test_batch_infer_cli import dataset_and_ckpt  # noqa: F401


def random_notes(rng, n=12):
    """Notes in absolute time, as infer_song gives them."""
    notes, t = [], 0.0
    for _ in range(n):
        dur = round(float(rng.uniform(0.02, 0.6)), 6)
        midi = float(rng.uniform(40, 80))
        notes.append({"start_time": round(t, 6), "end_time": round(t + dur, 6),
                      "note_seq": port_bi.calc_seq(midi, bool(rng.random() < 0.2)),
                      "note_dur": dur})
        t += dur
    return notes


def random_row(rng, total):
    n_ph = int(rng.integers(3, 9))
    cuts = np.sort(rng.uniform(0, total, n_ph - 1))
    durs = np.diff(np.concatenate([[0.0], cuts, [total]]))
    nums, left = [], n_ph
    while left:
        nums.append(int(rng.integers(1, min(3, left) + 1)))
        left -= nums[-1]
    return {"name": "x", "ph_seq": " ".join("a" * n_ph),
            "ph_dur": " ".join(f"{d:.6f}" for d in durs), "ph_num": " ".join(map(str, nums))}


@pytest.mark.parametrize("seed", range(4))
def test_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    for midi in rng.uniform(20, 100, 200).tolist() + [60.0, 60.005, 60.495, 60.5, 60.505]:
        for rest in (False, True):
            assert port_bi.calc_seq(midi, rest) == jax_bi.calc_seq(midi, rest)
    notes = random_notes(rng)
    total = notes[-1]["end_time"]
    row = random_row(rng, total)
    durs = [round(float(x), 6) for x in row["ph_dur"].split()]
    nums = [int(x) for x in row["ph_num"].split()]
    windows = port_bi.word_windows(durs, nums)
    assert windows == jax_bi.word_windows(durs, nums)
    aligned = port_bi.align_to_words(copy.deepcopy(notes), windows)
    assert aligned == jax_bi.align_to_words(copy.deepcopy(notes), windows)
    for window in windows + [(0.0, total), (total / 3, total / 2)]:
        assert (port_bi.overlapping_notes(window, aligned)
                == jax_bi.overlapping_notes(window, aligned))
        assert port_bi.max_overlap_note(window, aligned) == jax_bi.max_overlap_note(window, aligned)
    for round_midi in (False, True):
        got, want = dict(row), dict(row)
        port_bi.label_row(got, copy.deepcopy(notes), round_midi)
        jax_bi.label_row(want, copy.deepcopy(notes), round_midi)
        assert got == want


class SeededEngine:
    """Seeded segments for whatever chunks it is given: infer_song's
    flattening to absolute time, without a model."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def infer(self, waveforms):
        out = []
        for w in waveforms:
            n = int(self.rng.integers(1, 8))
            dur = self.rng.uniform(0.05, 0.4, n)
            out.append({"note_midi": self.rng.uniform(40, 80, n), "note_dur": dur,
                        "note_rest": self.rng.random(n) < 0.3})
        return out


def test_infer_song_matches_jax(tmp_path):
    from tests.test_inference import synth

    from some_tpu_torch.audio.wavio import save_wav

    sr = 44100
    wave = np.concatenate([synth(5.5, 440.0, seed=1), np.zeros(sr, np.float32),
                           synth(2.0, 330.0, seed=2)])
    wav = tmp_path / "song.wav"
    save_wav(wav, wave, sr)
    config = {"audio_sample_rate": sr}
    got = port_bi.infer_song(wav, SeededEngine(3), config)
    want = jax_bi.infer_song(wav, SeededEngine(3), config)
    assert len(got) > 2 and got == want


def read_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("round_midi", [False, True])
def test_cli_matches_the_jax_cli(dataset_and_ckpt, tmp_path, round_midi):  # noqa: F811
    from click.testing import CliRunner

    dataset, ckpt = dataset_and_ckpt
    # the fixture's checkpoint beside a config in f32, where the two engines
    # agree to f32 rounding (bf16 notes agree only at F1 >= 0.95)
    ckpt = shutil.copy(ckpt, tmp_path / ckpt.name)
    config = yaml.safe_load((dataset_and_ckpt[1].parent / "config.yaml").read_text())
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(dict(config,
                                                              pl_trainer_precision="32-true")))
    flags = ["--round_midi"] if round_midi else []
    jax_csv, port_csv = tmp_path / "jax.csv", tmp_path / "port.csv"
    result = CliRunner().invoke(jax_bi.batch_infer, ["--dataset", str(dataset), "--model",
                                                     str(ckpt), "--csv", str(jax_csv), *flags])
    assert result.exit_code == 0, result.output
    port_bi.main(["--dataset", str(dataset), "--model", str(ckpt), "--csv", str(port_csv),
                  "--device", "cpu", *flags])
    want, got = read_rows(jax_csv), read_rows(port_csv)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("name", "ph_seq", "ph_dur", "ph_num")} == \
            {k: w[k] for k in ("name", "ph_seq", "ph_dur", "ph_num")}
        assert g["note_seq"].split() == w["note_seq"].split() and g["note_seq"]
        np.testing.assert_allclose([float(d) for d in g["note_dur"].split()],
                                   [float(d) for d in w["note_dur"].split()], rtol=0, atol=1e-6)
        assert sum(float(d) for d in g["note_dur"].split()) == pytest.approx(1.4, abs=1e-4)
        if round_midi:
            assert len(g["note_seq"].split()) == 3
    with pytest.raises(FileExistsError, match="--overwrite"):
        port_bi.main(["--dataset", str(dataset), "--model", str(ckpt), "--csv", str(port_csv),
                      "--device", "cpu"])
    port_bi.main(["--dataset", str(dataset), "--model", str(ckpt), "--csv", str(port_csv),
                  "--device", "cpu", "--overwrite", *flags])
    assert read_rows(port_csv) == got


def test_cli_needs_a_card_and_one_device(dataset_and_ckpt, tmp_path, monkeypatch):  # noqa: F811
    import torch

    dataset, ckpt = dataset_and_ckpt
    args = ["--dataset", str(dataset), "--model", str(ckpt), "--csv", str(tmp_path / "o.csv")]
    n = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(RuntimeError, match=f"not present \\({torch.cuda.device_count()} CUDA"):
        port_bi.main(args + ["--devices", str(n)])
    assert not (tmp_path / "o.csv").exists()
    # two CPU replicas serve (their CSV against the JAX CLI's: test_torch_mesh.py)
    port_bi.main(args + ["--device", "cpu", "--devices", "2"])
    assert len(read_rows(tmp_path / "o.csv")) == 2
    (tmp_path / "o.csv").unlink()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_bi.main(args)
    assert not (tmp_path / "o.csv").exists()
