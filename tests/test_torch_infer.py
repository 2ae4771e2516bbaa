"""The PyTorch port's infer path end to end against the JAX package's.

Both CLIs read the same native msgpack checkpoint (small geometry, weights
from ``MidiExtractor.init`` with randomized BatchNorm statistics) and the
same synthetic songs of tests/test_prod_parity.py; the port runs with
``--device cpu``, where every kernel takes its plain version.
"""
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from some_tpu.audio.wavio import save_wav
from some_tpu.inference.me_infer import MIDIExtractionInference as JaxEngine
from some_tpu.nn.model import build_midi_extractor as jax_build
from some_tpu.training.checkpoint import save_checkpoint
from some_tpu.utils.midi_file import MidiFile
from some_tpu.utils.note_f1 import note_f1
from some_tpu_torch.compat.from_jax import jax_params_to_state_dict
from some_tpu_torch.inference.me_infer import MIDIExtractionInference
from some_tpu_torch.utils.midi_file import midi_notes_to_arrays
from tests.test_prod_parity import make_song

REPO = pathlib.Path(__file__).resolve().parent.parent
SR = 44100
CONFIG = {
    "audio_sample_rate": SR, "hop_size": 512, "win_size": 2048, "fmin": 40, "fmax": 8000,
    "units_dim": 80, "midi_num_bins": 128, "midi_min": 0, "midi_max": 127,
    "midi_prob_deviation": 1.0, "rest_threshold": 0.1, "units_encoder": "mel",
    "task_cls": "training.MIDIExtractionTask", "transfer_dtype": "int16",
    "midi_extractor_args": {
        "lay": 2, "dim": 64, "use_lay_skip": True, "kernel_size": 31, "conv_drop": 0.1,
        "ffn_latent_drop": 0.1, "ffn_out_drop": 0.1, "attention_drop": 0.1,
        "attention_heads": 2, "attention_heads_dim": 32},
}


@pytest.fixture(scope="module")
def variables():
    model = jax_build(CONFIG)
    v = model.init(jax.random.PRNGKey(0), np.zeros((1, 32, 80), np.float32))
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32), v["batch_stats"])
    return {"params": jax.tree_util.tree_map(np.asarray, v["params"]), "batch_stats": stats}


@pytest.fixture(scope="module")
def songs(tmp_path_factory):
    d = tmp_path_factory.mktemp("songs")
    paths = []
    for i in range(2):
        paths.append(d / f"song{i}.wav")
        save_wav(paths[-1], make_song(1000 + i), SR)
    return paths


def _notes(path):
    return MidiFile.load(path).notes()


@pytest.mark.parametrize("precision", ["32-true", "bf16"])
def test_cli_matches_jax_cli(tmp_path, variables, songs, precision):
    from click.testing import CliRunner

    import infer as jax_cli
    from some_tpu_torch.infer import main as port_cli

    config = dict(CONFIG, pl_trainer_precision=precision)
    ckpt = save_checkpoint(tmp_path, 1000, variables["params"], variables["batch_stats"])
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(config))
    for i, wav in enumerate(songs):
        jax_mid, port_mid = tmp_path / f"jax{i}.mid", tmp_path / f"port{i}.mid"
        result = CliRunner().invoke(jax_cli.infer, ["--model", str(ckpt), "--wav", str(wav),
                                                    "--midi", str(jax_mid)])
        assert result.exit_code == 0, result.output
        port_cli(["--model", str(ckpt), "--wav", str(wav), "--midi", str(port_mid),
                  "--device", "cpu"])
        want, got = _notes(jax_mid), _notes(port_mid)
        assert len(want) > 0
        if precision == "32-true":
            assert got == want
        else:
            f1 = note_f1(midi_notes_to_arrays(MidiFile.load(jax_mid)),
                         midi_notes_to_arrays(MidiFile.load(port_mid)),
                         onset_tolerance=0.05, pitch_tolerance=0.5).f1
            assert f1 >= 0.95, f1


def test_oversize_split_matches_jax(variables):
    """A chunk longer than the largest frame bucket splits at the bucket
    boundary and is joined by merge_parts, as in the JAX engine."""
    jax_engine = JaxEngine.from_variables(CONFIG, variables, dtype=jnp.float32)
    port = MIDIExtractionInference.from_state_dict(
        CONFIG, jax_params_to_state_dict(variables["params"], variables["batch_stats"]),
        dtype=torch.float32, device="cpu")
    jax_engine.frame_buckets = port.frame_buckets = (64, 128)
    wave = make_song(1002)[:300 * 512]  # ~300 frames: three parts
    short = make_song(1003)[:90 * 512]
    want = jax_engine.infer([wave, short])
    got = port.infer([wave, short])
    assert port.forwards == 2  # one group per bucket: the 128-frame parts, the 90-frame chunk
    for g, w in zip(got, want):
        assert len(w["note_dur"]) > 0
        np.testing.assert_array_equal(g["note_rest"], w["note_rest"])
        np.testing.assert_allclose(g["note_dur"], w["note_dur"], rtol=0, atol=1e-12)
        np.testing.assert_allclose(g["note_midi"], w["note_midi"], rtol=1e-5, atol=1e-5)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import some_tpu_torch\n"
        "for m in pkgutil.walk_packages(some_tpu_torch.__path__, 'some_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'some_tpu', 'yaml', 'click', 'msgpack', "
        "'h5py', 'tensorboardX', 'matplotlib'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('some_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 20


def test_engine_without_device_needs_cuda(monkeypatch, tmp_path, variables, songs):
    from some_tpu_torch.infer import main as port_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = jax_params_to_state_dict(variables["params"], variables["batch_stats"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MIDIExtractionInference.from_state_dict(CONFIG, state)
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(CONFIG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli(["--model", str(tmp_path / "model.ckpt"), "--wav", str(songs[0])])


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card, or away from the checkout, the smoke test fails and
    prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
