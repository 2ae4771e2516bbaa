"""The quantized (discrete, 129-class) model of the PyTorch port against the
JAX package's, on the CPU: the cross-entropy, collation, 3 train steps of
``QuantizedMIDIExtractionTask``, its validation decode, the engine
(``QuantizedMIDIExtractionInference``) and the train and infer CLIs.

Small geometry (1 layer, dim 32, 2 x 16 heads, k 7, 16 input features for
the task; 80 mels for the engine), 129 classes (class 128 = rest), numpy
seeds for every input; f32. Each test states its tolerance.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from some_tpu.inference.me_quant_infer import QuantizedMIDIExtractionInference as JaxEngine
from some_tpu.nn.model import build_midi_extractor as jax_build
from some_tpu.parallel.mesh import make_mesh, shard_batch
from some_tpu.training import losses as jax_losses
from some_tpu.training.me_quant_task import QuantizedMIDIExtractionTask as JaxTask
from some_tpu.training.me_quant_task import framewise_labels as jax_framewise_labels
from some_tpu_torch.compat.from_jax import jax_params_to_state_dict
from some_tpu_torch.inference.base_infer import TASK_INFERENCE_MAPPING
from some_tpu_torch.inference.me_quant_infer import QuantizedMIDIExtractionInference
from some_tpu_torch.train import TASKS, build_task
from some_tpu_torch.training import losses
from some_tpu_torch.training.me_quant_task import QuantizedMIDIExtractionTask, framewise_labels
from tests.test_inference import synth
from tests.test_torch_train import REPO, _np, assert_state_matches
from tests.test_train_parity import make_items, parity_config
from tests.test_training import TINY_CONFIG, make_item

ENGINE_CONFIG = {
    "audio_sample_rate": 44100, "hop_size": 512, "win_size": 2048, "fmin": 40, "fmax": 8000,
    "units_dim": 80, "midi_num_bins": 129, "midi_min": 0, "midi_max": 127,
    "units_encoder": "mel", "task_cls": "training.QuantizedMIDIExtractionTask",
    "transfer_dtype": "int16",
    "midi_extractor_args": {
        "lay": 1, "dim": 32, "use_lay_skip": True, "kernel_size": 7, "conv_drop": 0.1,
        "ffn_latent_drop": 0.1, "ffn_out_drop": 0.1, "attention_drop": 0.1,
        "attention_heads": 2, "attention_heads_dim": 16},
}


def _config():
    config = parity_config()
    config.update(midi_num_bins=129, task_cls="training.QuantizedMIDIExtractionTask")
    for key in ("midi_prob_deviation", "rest_threshold"):  # the discrete configs lack them
        config.pop(key)
    return config


def quant_items(rng, frame_counts, note_counts):
    """make_items with integer note labels, rests as class 128."""
    items = make_items(rng, frame_counts, note_counts)
    for item in items:
        rest = item.pop("note_rest")
        midi = rng.integers(40, 80, len(rest)).astype(np.int64)
        midi[rest] = 128
        item["note_midi"] = midi
    return items


def _batches(task, n, seed):
    """Rows of 56, 41 and 30 real frames: a 64-frame bucket and a padding row."""
    rng = np.random.default_rng(seed)
    return [task.collate(quant_items(rng, [56, 41, 30], [8, 6, 4])) for _ in range(n)]


def test_cross_entropy_ignore_matches_jax():
    """Loss rtol 1e-6 and its gradient |d| <= 1e-7, ignored labels (-1) and
    an all-ignored row included."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 20, 129)) * 4).astype(np.float32)
    labels = rng.integers(0, 129, (3, 20))
    labels[0, 15:] = -1
    labels[2] = -1
    want, want_grad = jax.value_and_grad(jax_losses.cross_entropy_ignore)(
        jnp.asarray(logits), jnp.asarray(labels))
    lt = torch.from_numpy(logits).requires_grad_()
    got = losses.cross_entropy_ignore(lt, torch.from_numpy(labels))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_grad), atol=1e-7, rtol=0)
    assert float(losses.cross_entropy_ignore(lt.detach(), torch.full((3, 20), -1))) == 0.0


def test_collate_and_labels_match_jax():
    """The collated batch (note_midi padded with -1) and the framewise labels
    equal the JAX task's, array for array."""
    config = _config()
    jtask, task = JaxTask(dict(config)), QuantizedMIDIExtractionTask(dict(config), device="cpu")
    items = quant_items(np.random.default_rng(5), [56, 41, 30], [8, 6, 4])
    want, got = jtask.collate(items), task.collate(items)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert (got["note_midi"][:, 8:] == -1).all() and got["note_midi"].dtype == np.int64
    labels = framewise_labels(torch.from_numpy(got["note_midi"]), torch.from_numpy(got["unit2note"]))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jax_framewise_labels(
        jnp.asarray(want["note_midi"]), jnp.asarray(want["unit2note"]))))


def _dw_bias_walk(model, jax_state) -> dict:
    """|port - JAX| of every depthwise bias, by its BatchNorm's running_mean key."""
    want = jax_params_to_state_dict(_np(jax_state.params))
    got = model.state_dict()
    return {k.replace("dw.bias", "bn.running_mean"): (got[k] - want[k]).abs()
            for k in want if k.endswith("conv.dw.bias")}


def test_train_steps_match_jax():
    """3 steps, f32, dropout 0, a ragged batch with a padding row: losses
    rtol 1e-3, grad norms rtol 2e-3, then the state, as
    tests/test_torch_train.py holds the continuous task (parameters by RMS,
    share above 1e-4 and 99.9th percentile; BatchNorm statistics
    elementwise). The port starts from the JAX task's initial weights.

    One allowance on top: a depthwise bias has a gradient of pure float
    noise (the BatchNorm after the conv cancels it), so AdamW walks it at lr
    scale in another direction in each framework, and the BatchNorm's
    running mean takes 0.1 of that bias at every step. Each running_mean is
    held to 1e-4 + 1e-4 |want| plus 0.1 x the sum over steps of its bias's
    walk (measured: walks up to 1.7e-3, running means 1.3e-4 apart)."""
    config = dict(_config(), use_remat=False)
    jtask = JaxTask(dict(config))
    mesh = make_mesh(jax.devices()[:1])
    jstep = jtask.make_train_step(mesh, donate=False)
    jstate = jtask.init_state()
    task = build_task(dict(config, use_remat=True), device="cpu")
    assert isinstance(task, QuantizedMIDIExtractionTask)
    state = task.init_state()
    state.model.load_state_dict(jax_params_to_state_dict(_np(jstate.params),
                                                         _np(jstate.batch_stats)))
    walk = None
    for batch in _batches(task, 3, seed=13):
        assert batch["units"].shape[:2] == (4, 64) and batch["batch_mask"].sum() == 3
        jstate, jlogs = jstep(jstate, shard_batch(batch, mesh))
        logs = task.train_step(state, batch)
        for key in ("midi_loss", "bound_loss", "total_loss"):
            assert float(logs[key]) == pytest.approx(float(jlogs[key]), rel=1e-3, abs=1e-6), key
        assert float(logs["grad_norm"]) == pytest.approx(float(jlogs["grad_norm"]), rel=2e-3)
        step_walk = _dw_bias_walk(state.model, jstate)
        walk = step_walk if walk is None else {k: walk[k] + v for k, v in step_walk.items()}
    assert state.step == int(jstate.step) == 3
    want = jax_params_to_state_dict(_np(jstate.params), _np(jstate.batch_stats))
    got = state.model.state_dict()
    for key, allowance in walk.items():
        d = (got[key] - want[key]).abs()
        assert (d <= 1e-4 + 1e-4 * want[key].abs() + 0.1 * allowance).all(), key
    # the rest as tests/test_torch_train.py holds it, the running means checked above
    assert_state_matches(state.model, _with_batch_stats(jstate, state.model))


def test_valid_outputs_match_jax():
    """Argmax decode and midi_acc counters on the same outputs: counts,
    durations, rests and argmax pitches exact, probs to 1e-6."""
    config = _config()
    task = QuantizedMIDIExtractionTask(dict(config), device="cpu")
    jtask = JaxTask(dict(config))
    batch = _batches(task, 1, seed=31)[0]
    rng = np.random.default_rng(31)
    logits = (rng.standard_normal((4, 64, 129)) * 3).astype(np.float32)
    logits[:, :, 128] += (rng.random((4, 64)) < 0.2) * 10  # some rest frames
    bounds = (rng.random((4, 64)) < 0.1).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    want = jax.jit(jtask.valid_outputs)((jnp.asarray(logits), jnp.asarray(bounds)), jbatch)
    tb = task.to_device(batch)
    got = task.valid_outputs((torch.from_numpy(logits), torch.from_numpy(bounds)), tb)
    assert int(got["midi_acc_total"]) == int(want["midi_acc_total"]) > 0
    assert int(got["midi_acc_correct"]) == int(want["midi_acc_correct"])
    assert bool((got["midi_pred"] == -torch.inf).any())
    for key in ("n_notes", "note_dur", "note_rest", "note_midi", "midi_pred", "midi_gt"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key in ("probs", "bounds"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-6, rtol=0,
                                   err_msg=key)
    jlosses = jax.jit(jtask.compute_losses)((jnp.asarray(logits), jnp.asarray(bounds)), jbatch)
    got_losses = task.compute_losses((torch.from_numpy(logits), torch.from_numpy(bounds)), tb)
    for key, value in jlosses.items():
        assert float(got_losses[key]) == pytest.approx(float(value), rel=1e-5), key


def _with_batch_stats(jax_state, model):
    """``jax_state`` with its BatchNorm running means replaced by the
    model's (held apart, with their allowance, by the caller)."""
    stats = jax.tree_util.tree_map(np.array, _np(jax_state.batch_stats))
    got = model.state_dict()

    def fill(tree, prefix):
        for name, sub in tree.items():
            if isinstance(sub, dict):
                fill(sub, prefix + (name,))
            elif name == "mean":
                tree[name] = got[".".join(prefix + ("running_mean",))].numpy()
    fill(stats, ())
    return jax_state.replace(batch_stats=stats)


@pytest.fixture(scope="module")
def engines():
    v = _np(jax_build(ENGINE_CONFIG).init(jax.random.PRNGKey(1), np.zeros((1, 64, 80), np.float32),
                                          mask=np.ones((1, 64), bool)))
    rng = np.random.default_rng(4)
    stats = jax.tree_util.tree_map(lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32),
                                   v["batch_stats"])
    jax_engine = JaxEngine.from_variables(dict(ENGINE_CONFIG),
                                          {"params": v["params"], "batch_stats": stats},
                                          dtype=jnp.float32)
    port = QuantizedMIDIExtractionInference.from_state_dict(
        dict(ENGINE_CONFIG), jax_params_to_state_dict(v["params"], stats),
        dtype=torch.float32, device="cpu")
    return jax_engine, port


def test_engine_matches_jax_engine(engines):
    """The same notes as the JAX engine in f32 (rests and durations exact,
    pitches integers in [0, 127]), and a chunk bucketed with another equals
    it alone (tests/test_quant_infer.py)."""
    jax_engine, port = engines
    assert TASK_INFERENCE_MAPPING[ENGINE_CONFIG["task_cls"]].endswith(
        "QuantizedMIDIExtractionInference")
    assert port.midi_deviation == 1.0 and port.rest_threshold == 0.1
    waves = [synth(0.8, 262, seed=4), synth(1.2, 392, seed=5), synth(2.6, 330, seed=6)]
    want, got = jax_engine.infer(waves), port.infer(waves)
    for g, w in zip(got, want):
        assert len(w["note_dur"]) > 0
        for key in ("note_midi", "note_dur", "note_rest"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        assert np.array_equal(g["note_midi"], np.round(g["note_midi"]))
        assert (g["note_midi"] >= 0).all() and (g["note_midi"] <= 127).all()
    solo = port.infer([waves[1]])[0]
    for key in ("note_midi", "note_dur", "note_rest"):
        np.testing.assert_array_equal(solo[key], got[1][key])


def test_train_cli_routes_both_names_and_trains_then_infers(tmp_path):
    """Both of the JAX package's names route to the task; python -m
    some_tpu_torch.train --device cpu trains the discrete model 3 steps on
    an HDF5 set and python -m some_tpu_torch.infer transcribes with its
    checkpoint (integer pitches)."""
    from some_tpu.audio.wavio import save_wav
    from some_tpu_torch.config import save_yaml
    from some_tpu_torch.data.indexed_dataset import IndexedDatasetWriter, save_lengths
    from some_tpu_torch.utils.midi_file import MidiFile

    for name in ("training.QuantizedMIDIExtractionTask",
                 "some_tpu.training.me_quant_task.QuantizedMIDIExtractionTask"):
        assert TASKS[name] is QuantizedMIDIExtractionTask
        assert TASK_INFERENCE_MAPPING[name].endswith("QuantizedMIDIExtractionInference")
    rng = np.random.default_rng(114514)
    data_dir = tmp_path / "binary"
    for prefix, n_items in (("train", 6), ("valid", 2)):
        lengths = []
        with IndexedDatasetWriter(data_dir, prefix) as writer:
            for _ in range(n_items):
                item = make_item(rng, int(rng.integers(40, 120)), int(rng.integers(3, 8)),
                                 units_dim=80, quant=True)
                writer.add_item(item)
                lengths.append(item["length"])
        save_lengths(data_dir, prefix, lengths)
    config = dict(TINY_CONFIG, binary_data_dir=str(data_dir), units_encoder="mel",
                  units_dim=80, midi_num_bins=129, pl_trainer_precision="32-true",
                  task_cls="training.QuantizedMIDIExtractionTask", quantize="int8",
                  val_check_interval=3, ds_workers=1)
    for key in ("midi_prob_deviation", "rest_threshold"):
        config.pop(key)
    save_yaml(config, tmp_path / "discrete.yaml")
    train = subprocess.run(
        [sys.executable, "-m", "some_tpu_torch.train", "--config", str(tmp_path / "discrete.yaml"),
         "--exp_name", "d", "--work_dir", str(tmp_path / "exp"), "--max_steps", "3",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert train.returncode == 0, train.stdout[-2000:] + train.stderr[-2000:]
    ckpt = tmp_path / "exp" / "d" / "model_ckpt_steps_3.ckpt"
    assert ckpt.exists()
    save_wav(tmp_path / "song.wav", synth(2.0, 440), 44100)
    for quantize in ("none", "int8"):
        mid = tmp_path / f"song-{quantize}.mid"
        infer = subprocess.run(
            [sys.executable, "-m", "some_tpu_torch.infer", "--model", str(ckpt),
             "--wav", str(tmp_path / "song.wav"), "--midi", str(mid), "--quantize", quantize,
             "--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
        assert infer.returncode == 0, infer.stderr[-2000:]
        notes = MidiFile.load(mid).notes()
        assert all(0 <= n["note"] <= 127 for n in notes)
