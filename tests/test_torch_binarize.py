"""Preprocessing of the PyTorch port against the JAX package, on the CPU.

The synthetic DiffSinger dataset of tests/test_binarize_e2e.py (three
items of A3 / rest / C4+20 sung sines) goes through the JAX binarizer and
the port's; every HDF5 item must be equal array for array, and the
.lengths equal. ``pe: yin`` and the labels are numpy in both, so they are
exact; with ``pe: rmvpe`` on one random ``model.pt`` the pitch is held to
RMVPE's tolerance and everything else exactly; with ContentVec units, the
units to ContentVec's. Also: the quantized binarizer, spawned workers,
both CLIs, the label helpers bit for bit, two steps of the port's trainer
on what the port wrote, and bench_binarize.
"""
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from some_tpu.preprocessing import label_utils as jax_labels
from some_tpu.preprocessing.me_binarizer import MIDIExtractionBinarizer as JaxBinarizer
from some_tpu.preprocessing.me_quant_binarizer import (
    QuantizedMIDIExtractionBinarizer as JaxQuantBinarizer,
)
from some_tpu_torch.nn.rmvpe import random_state_dict
from some_tpu_torch.preprocessing import BINARIZERS, binarizer_class, label_utils
from some_tpu_torch.preprocessing.me_binarizer import MIDIExtractionBinarizer
from some_tpu_torch.preprocessing.me_quant_binarizer import QuantizedMIDIExtractionBinarizer
from test_binarize_e2e import write_raw_dataset

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
SR = 44100


def bin_config(root, binary, **overrides):
    config = {
        "raw_data_dir": [str(root)], "binary_data_dir": str(binary),
        "binarization_args": {"num_workers": 0, "shuffle": True,
                              "skip_glide": True, "merge_rest": True,
                              "merge_slur": True, "round_midi": False,
                              "slur_tolerance": 0.5},
        "audio_sample_rate": SR, "hop_size": 512, "win_size": 2048,
        "fmin": 40, "fmax": 8000, "units_dim": 80, "units_encoder": "mel",
        "pe": "yin", "pe_ckpt": None,
        "key_shift_factor": 1, "key_shift_range": [-3, 3],
        "test_prefixes": ["item0"], "seed": 114514,
        "midi_min": 0, "midi_max": 127,
    }
    for key, value in overrides.items():
        if key in config["binarization_args"]:
            config["binarization_args"] = dict(config["binarization_args"], **{key: value})
        else:
            config[key] = value
    return config


def read_binary(binary):
    """{prefix: ([item dicts], lengths)} of an HDF5 dataset directory."""
    out = {}
    for prefix in ("train", "valid"):
        with h5py.File(binary / f"{prefix}.data", "r") as f:
            items = [{k: f[str(i)][k][()] for k in f[str(i)]} for i in range(len(f))]
        out[prefix] = (items, np.load(binary / f"{prefix}.lengths"))
    return out


def assert_same_dataset(got, want, pitch_tol=None):
    for prefix in ("train", "valid"):
        items, lengths = got[prefix]
        want_items, want_lengths = want[prefix]
        np.testing.assert_array_equal(lengths, want_lengths)
        assert len(items) == len(want_items) > 0
        for item, want_item in zip(items, want_items):
            assert item.keys() == want_item.keys()
            for key in item:
                assert item[key].dtype == want_item[key].dtype, key
                if key == "pitch" and pitch_tol is not None:
                    np.testing.assert_allclose(item[key], want_item[key], atol=pitch_tol, rtol=0)
                else:
                    np.testing.assert_array_equal(item[key], want_item[key], err_msg=key)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    write_raw_dataset(root, np.random.default_rng(99))
    return root


@pytest.fixture(scope="module")
def rmvpe_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("rmvpe") / "model.pt"
    torch.save({"model": random_state_dict(5)}, path)
    return path


CASES = {
    "mel_yin_keyshift": {},
    "round_midi": {"round_midi": True, "key_shift_factor": 2},
    "no_shuffle_no_merge": {"shuffle": False, "merge_slur": False, "merge_rest": False,
                            "key_shift_factor": 0},
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("quantized", [False, True], ids=["continuous", "quantized"])
def test_binarized_dataset_matches_jax(raw, tmp_path, case, quantized):
    jax_cls, port_cls = ((JaxQuantBinarizer, QuantizedMIDIExtractionBinarizer) if quantized
                         else (JaxBinarizer, MIDIExtractionBinarizer))
    jax_cls(bin_config(raw, tmp_path / "jax", **CASES[case])).process()
    port_cls(bin_config(raw, tmp_path / "port", **CASES[case]), device="cpu").process()
    got, want = read_binary(tmp_path / "port"), read_binary(tmp_path / "jax")
    assert_same_dataset(got, want)
    n_train = 2 * (1 + bin_config(raw, "", **CASES[case])["key_shift_factor"])
    assert len(got["train"][0]) == n_train and len(got["valid"][0]) == 1
    assert (tmp_path / "port" / "midi_distribution.jpg").exists()


def test_spawned_workers_match_serial(raw, tmp_path):
    """num_workers 2: spawned processes, each with its own binarizer from
    binarizer_class, write what the JAX package's serial path writes."""
    JaxBinarizer(bin_config(raw, tmp_path / "jax")).process()
    MIDIExtractionBinarizer(bin_config(raw, tmp_path / "port", num_workers=2),
                            device="cpu").process()
    assert_same_dataset(read_binary(tmp_path / "port"), read_binary(tmp_path / "jax"))


def test_rmvpe_pitch_matches_jax(raw, rmvpe_ckpt, tmp_path):
    """pe: rmvpe on one random upstream model.pt, through the serial path's
    prepare_items (packed f0_batch): everything but the pitch exact, the
    pitch within 1e-3 semitone of JAX's; and the port's per-item path
    (extract_pitch, no prepare pass, one row a forward) within 1e-4 of the
    packed one (rows of another batch take other summation orders)."""
    config = dict(pe="rmvpe", pe_ckpt=str(rmvpe_ckpt))
    JaxBinarizer(bin_config(raw, tmp_path / "jax", **config)).process()
    MIDIExtractionBinarizer(bin_config(raw, tmp_path / "port", **config),
                            device="cpu").process()
    got = read_binary(tmp_path / "port")
    assert_same_dataset(got, read_binary(tmp_path / "jax"), pitch_tol=1e-3)
    per_item = MIDIExtractionBinarizer(bin_config(raw, tmp_path / "per_item", **config),
                                       device="cpu")
    per_item.prepare_items = None
    per_item.process()
    assert_same_dataset(read_binary(tmp_path / "per_item"), got, pitch_tol=1e-4)


def test_rmvpe_missing_checkpoint_falls_back_to_yin(raw, tmp_path, capsys):
    """The one fallback: a missing RMVPE file gives YIN's pitch, as in JAX."""
    missing = str(tmp_path / "absent" / "model.pt")
    MIDIExtractionBinarizer(bin_config(raw, tmp_path / "port", pe="rmvpe", pe_ckpt=missing),
                            device="cpu").process()
    JaxBinarizer(bin_config(raw, tmp_path / "jax")).process()
    assert_same_dataset(read_binary(tmp_path / "port"), read_binary(tmp_path / "jax"))
    assert "falling back to yin" in capsys.readouterr().out


def test_cli_matches_jax_cli(raw, tmp_path):
    """python -m some_tpu_torch.binarize --device cpu against binarize.py on
    one config file (through both config readers)."""
    from some_tpu_torch.config import save_yaml

    outputs = {}
    for name, cmd in (("jax", [sys.executable, str(REPO / "binarize.py")]),
                      ("port", [sys.executable, "-m", "some_tpu_torch.binarize",
                                "--device", "cpu"])):
        config = bin_config(raw, tmp_path / name,
                            binarizer_cls="preprocessing.MIDIExtractionBinarizer")
        save_yaml(config, tmp_path / f"{name}.yaml")
        run = subprocess.run(cmd + ["--config", str(tmp_path / f"{name}.yaml")], cwd=REPO,
                             capture_output=True, text=True, timeout=600)
        assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
        outputs[name] = read_binary(tmp_path / name)
    assert_same_dataset(outputs["port"], outputs["jax"])
    if not torch.cuda.is_available():
        run = subprocess.run([sys.executable, "-m", "some_tpu_torch.binarize", "--config",
                              str(tmp_path / "port.yaml")], cwd=REPO, capture_output=True,
                             text=True, timeout=300)
        assert run.returncode != 0 and "no CUDA device" in run.stderr


def test_port_trainer_takes_two_steps_on_port_binarized_data(raw, tmp_path):
    from some_tpu_torch.training.me_task import MIDIExtractionTask
    from some_tpu_torch.training.trainer import Trainer
    from test_training import TINY_CONFIG

    config = bin_config(raw, tmp_path / "binary")
    MIDIExtractionBinarizer(dict(config), device="cpu").process()
    train_config = dict(TINY_CONFIG, units_dim=80, binary_data_dir=str(tmp_path / "binary"),
                        ds_workers=0, val_check_interval=100)
    trainer = Trainer(MIDIExtractionTask(train_config, device="cpu"), tmp_path / "work")
    state = trainer.fit(max_steps=2)
    assert state.step == 2


def test_binarizer_names_resolve():
    for name in ("preprocessing.MIDIExtractionBinarizer",
                 "some_tpu.preprocessing.me_binarizer.MIDIExtractionBinarizer"):
        assert binarizer_class(name) is MIDIExtractionBinarizer
    for name in ("preprocessing.QuantizedMIDIExtractionBinarizer",
                 "some_tpu.preprocessing.me_quant_binarizer.QuantizedMIDIExtractionBinarizer"):
        assert binarizer_class(name) is QuantizedMIDIExtractionBinarizer
    for cls in set(BINARIZERS.values()):
        assert binarizer_class(f"{cls.__module__}.{cls.__qualname__}") is cls
    with pytest.raises(ValueError, match="no binarizer"):
        binarizer_class("preprocessing.BaseBinarizer")


# ---- the label helpers, bit for bit ----

def test_label_utils_bit_for_bit():
    notes = ["C4", "C4+10", "rest", "rest", "D4", "E4-30", "E4"]
    durs = [0.2, 0.3, 0.1, 0.15, 0.4, 0.2, 0.3]
    slurs = [False, True, False, False, False, False, True]
    for tol in (None, 0.5):
        assert label_utils.merge_slurs(notes, durs, slurs, tol) == \
            jax_labels.merge_slurs(notes, durs, slurs, tol)
    assert label_utils.merge_rests(notes, durs) == jax_labels.merge_rests(notes, durs)
    d = np.asarray(durs)
    np.testing.assert_array_equal(label_utils.durations_to_alignment(d, 200, 512 / SR),
                                  jax_labels.durations_to_alignment(d, 200, 512 / SR))
    curve = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    for k in (1, 4, 5):
        np.testing.assert_array_equal(label_utils.sinusoidal_smoothing(curve, k),
                                      jax_labels.sinusoidal_smoothing(curve, k))


# ---- the port's bench_binarize ----

def test_bench_binarize_line_and_pass_without_the_write(tmp_path):
    """The CPU line has the bench's keys and writes the HDF5 files; the pass
    without the write yields what process() writes, item for item, and the
    pass with the write keeps the items it wrote and times the writer."""
    from some_tpu_torch import bench_binarize

    line = bench_binarize.measure("cpu", items=2, min_s=1.5, max_s=2.5)
    for key in ("songs_per_min", "units_mel_s", "rmvpe_s", "rmvpe_forward_s",
                "host_other_s", "rmvpe_programs", "rmvpe_forwards"):
        assert line[key] >= 0, key
    assert line["hdf5_write"] is True and line["device"] == "cpu"
    assert line["rmvpe_programs"] >= 1

    raw = tmp_path / "raw"
    bench_binarize.write_song_dataset(raw, np.random.default_rng(3), [1.5, 2.0, 3.5])
    ckpt = bench_binarize.save_random_rmvpe(tmp_path / "model.pt", 3)
    config = bench_binarize.bench_config(raw, tmp_path / "binary", ckpt, units_dim=80)
    stats, groups = bench_binarize.timed_pass(config, "cpu", write=False)
    assert stats["hdf5_write"] is False and not (tmp_path / "binary" / "train.data").exists()
    stats, kept = bench_binarize.timed_pass(config, "cpu")
    assert stats["hdf5_write"] is True and stats["hdf5_write_s"] > 0
    for prefix in ("train", "valid"):
        for group, want in zip(kept[prefix], groups[prefix], strict=True):
            for item, want_item in zip(group, want, strict=True):
                assert item.keys() == want_item.keys()
                for key, value in want_item.items():
                    np.testing.assert_array_equal(item[key], value, err_msg=key)
    written = read_binary(tmp_path / "binary")
    for prefix in ("train", "valid"):
        items = [item for group in groups[prefix] for item in group]
        assert [i["length"] for i in items] == list(written[prefix][1])
        for item, want in zip(items, written[prefix][0]):
            for key, value in want.items():
                np.testing.assert_array_equal(item[key], value, err_msg=key)


def test_bench_binarize_needs_a_card_unless_told(monkeypatch):
    from some_tpu_torch import bench_binarize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_binarize.main([])


def test_contentvec_units_match_jax(raw, tmp_path):
    """units_encoder contentvec768l12: both binarizers on one fairseq-layout
    file (full width, two layers, both packages' encoders put in their
    caches under the configured path); units held to ContentVec's
    tolerance (atol 5e-5 / rtol 1e-4), everything else exact."""
    from some_tpu.nn.contentvec import ContentVecEncoder as JaxEncoder
    from some_tpu_torch.nn.contentvec import ContentVecEncoder
    from test_torch_contentvec import fake_fairseq_state

    state = fake_fairseq_state(np.random.default_rng(21))
    path = tmp_path / "checkpoint.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}}, path)
    JaxEncoder._cache[str(path)] = JaxEncoder(path, output_layer=2)
    ContentVecEncoder._cache[(str(path), "cpu")] = ContentVecEncoder(path, output_layer=2,
                                                                     device="cpu")
    try:
        config = dict(units_encoder="contentvec768l12", units_encoder_ckpt=str(path),
                      units_dim=768, key_shift_factor=0)
        JaxBinarizer(bin_config(raw, tmp_path / "jax", **config)).process()
        MIDIExtractionBinarizer(bin_config(raw, tmp_path / "port", **config),
                                device="cpu").process()
    finally:
        JaxEncoder._cache.pop(str(path), None)
        ContentVecEncoder._cache.pop((str(path), "cpu"), None)
    got, want = read_binary(tmp_path / "port"), read_binary(tmp_path / "jax")
    for prefix in ("train", "valid"):
        for item, want_item in zip(got[prefix][0], want[prefix][0]):
            assert item["units"].shape[1] == 768
            np.testing.assert_allclose(item.pop("units"), want_item.pop("units"),
                                       atol=5e-5, rtol=1e-4)
    assert_same_dataset(got, want)
