"""The port's serving mesh (``some_tpu_torch/parallel/mesh.py`` and the
engine's ``mesh``) against the JAX package's on the CPU.

The JAX engine shards bucket rows over ``make_mesh(jax.devices()[:N])`` of
the conftest's 8 virtual CPU devices; the port keeps N engine replicas on the
CPU. Both take the same weights (``MidiExtractor.init`` at
tests/test_inference.py's TINY_MODEL_CONFIG, carried across by
``compat/from_jax``), in f32, and are held to the notes of
tests/test_mesh_inference.py's tolerances: note_midi 1e-4, rests equal,
durations 1e-9. Then the int8 engine on a mesh against JAX's int8 mesh
(note F1 1.0: every replica takes the whole bucket's activation scale, as
GSPMD gives JAX's) and against a one-device int8 engine on the whole
padded bucket, the padding rows of every wire, the shard buckets
``prewarm`` builds, and the infer and batch_infer CLIs with ``--devices 2``
against the JAX CLIs'.
"""
import csv
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from some_tpu.audio.wire import decode_wire_device as jax_decode_wire
from some_tpu.inference.me_infer import MIDIExtractionInference as JaxEngine
from some_tpu.nn.model import build_midi_extractor as jax_build
from some_tpu.parallel.mesh import make_mesh as jax_make_mesh
from some_tpu.training.checkpoint import save_checkpoint
from some_tpu.utils.midi_file import MidiFile
from some_tpu_torch.audio.wire import decode_wire_device, silence_buffer
from some_tpu_torch.compat.from_jax import jax_params_to_state_dict
from some_tpu_torch.inference.me_infer import MIDIExtractionInference
from some_tpu_torch.parallel.mesh import (
    DATA_AXIS, local_mesh_size, make_mesh, pad_rows, split_rows,
)
from tests.test_batch_infer_cli import dataset_and_ckpt  # noqa: F401
from tests.test_inference import TINY_MODEL_CONFIG, synth
from tests.test_torch_infer import songs  # noqa: F401
from tests.test_torch_quant import _f1

CONFIG = dict(TINY_MODEL_CONFIG, transfer_dtype="float32")


@pytest.fixture(scope="module")
def variables():
    """tests/test_mesh_inference.py's weights."""
    v = jax_build(CONFIG).init(jax.random.PRNGKey(21), np.zeros((1, 64, 80), np.float32),
                               mask=np.ones((1, 64), bool))
    return jax.tree_util.tree_map(np.asarray, v)


def state_of(variables):
    return jax_params_to_state_dict(variables["params"], variables.get("batch_stats"))


def port_engine(variables, n=None, **overrides):
    mesh = None if n is None else make_mesh(["cpu"] * n)
    return MIDIExtractionInference.from_state_dict(
        dict(CONFIG, **overrides), state_of(variables), dtype=torch.float32,
        **({"device": "cpu"} if mesh is None else {"mesh": mesh}))


def jax_engine(variables, n=None, **overrides):
    mesh = None if n is None else jax_make_mesh(jax.devices()[:n])
    return JaxEngine.from_variables(dict(CONFIG, **overrides), variables, dtype=jnp.float32,
                                    mesh=mesh)


def assert_notes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["note_midi"], w["note_midi"], atol=1e-4)
        np.testing.assert_array_equal(g["note_rest"], w["note_rest"])
        np.testing.assert_allclose(g["note_dur"], w["note_dur"], atol=1e-9)


WAVS = {3: [synth(1.0, 440, seed=1), synth(1.3, 523, seed=2), synth(0.8, 330, seed=3)],
        8: [synth(1.0, 300 + 30 * i, seed=i) for i in range(8)]}


@pytest.mark.parametrize("chunks", [3, 8], ids=["padded", "full"])
@pytest.mark.parametrize("n", [2, 8])
def test_mesh_matches_jax_mesh_and_one_device(variables, n, chunks):
    """N replicas give the JAX mesh engine's notes and the port's one-device
    engine's: 3 chunks (rows padded to the mesh) and 8 (no padding rows at
    N = 8). Each replica ran the forwards of its shard; the bucket counts
    hold one set a replica, and their real frames summed are the one-device
    engine's."""
    wavs = WAVS[chunks]
    mesh = port_engine(variables, n)
    assert len(mesh.replicas) == n and all(r.device.type == "cpu" for r in mesh.replicas)
    assert len({id(r.model) for r in mesh.replicas}) == n
    got = mesh.infer(wavs)
    one = port_engine(variables)
    assert_notes(got, jax_engine(variables, n).infer(wavs))
    assert_notes(got, one.infer(wavs))
    assert len({r.forwards for r in mesh.replicas}) == 1 and mesh.forwards >= 1
    counts = mesh.bucket_counts()
    assert {c["replica"] for c in counts} == set(range(n))
    for i, replica in enumerate(mesh.replicas):
        assert sum(c["forwards"] for c in counts if c["replica"] == i) == replica.forwards
    assert sum(c["real_frames"] for c in counts) == sum(
        c["real_frames"] for c in one.bucket_counts()) > 0


def test_run_bucket_rows_in_the_callers_order(variables):
    """One bucket of 3 rows over 2 replicas: padded to 4, shards of 2, the
    outputs gathered in the caller's order; the padding row decodes to no
    notes, and the real rows equal the one-device engine's."""
    mesh, solo = port_engine(variables, 2), port_engine(variables)
    groups, _ = solo.bucket_groups(WAVS[3])
    (_, audio, mask), = groups
    assert audio.shape[0] == 3
    audio_shards, mask_shards, ready = mesh.stage_inputs(audio, mask)
    assert [tuple(a.shape) for a in audio_shards] == [(2, audio.shape[1])] * 2
    assert ready == (None, None)
    got = mesh.run_bucket_staged(audio_shards, mask_shards, frames=True)
    want = solo.run_bucket(audio, mask)
    assert got["n_notes"].shape[0] == 4 and int(got["n_notes"][3]) == 0
    for key, value in want.items():
        torch.testing.assert_close(got[key][:3], value, rtol=0, atol=1e-4)
    assert got["probs"].shape[:2] == (4, mask.shape[1])
    # each replica runs its shard under inference mode, as the engine does
    shard = mesh.replicas[1]._run(audio_shards[1], mask_shards[1], None, False, False)
    assert all(v.is_inference() for v in (*got.values(), *shard.values()))


@pytest.mark.parametrize("chunks", [3, 8], ids=["padded", "full"])
@pytest.mark.parametrize("n", [2, 8])
def test_int8_engine_on_a_mesh(variables, n, chunks):
    """``quantize: int8`` on a mesh, against JAX's int8 mesh engine and the
    port's one-device int8 engine.

    Each replica quantizes the f32 weights as it loads them (the same int8
    weights on every replica). At every int8 site the replicas exchange
    their shards' max|x| (``ops/replica_max.py``, the barrier of the CPU
    replicas' threads), so the activation scale is the whole padded
    bucket's, as GSPMD's all-reduce makes JAX's. So the mesh's outputs equal
    a one-device int8 engine's run of the whole padded bucket (bit for bit:
    the CPU's products here do not depend on the row count), and its notes
    are JAX's int8 mesh's (note F1 1.0, counts and rests equal)."""
    wavs = WAVS[chunks]
    mesh, solo = port_engine(variables, n, quantize="int8"), port_engine(variables,
                                                                         quantize="int8")
    states = [r.model.state_dict() for r in mesh.replicas]
    int8 = [k for k, t in states[0].items() if t.dtype == torch.int8]
    assert int8 and all(torch.equal(s[k], states[0][k]) for s in states[1:] for k in int8)
    assert mesh.weight_bytes == n * solo.weight_bytes
    groups, _ = solo.bucket_groups(wavs)
    for _, audio, mask in groups:
        got = mesh.run_bucket(audio, mask)
        want = solo.run_bucket(*pad_rows(audio, mask, n, mesh.wire,
                                         mask.shape[1] * mesh.hop - 1))
        for key in got:
            assert torch.equal(got[key], want[key]), key
    notes = mesh.infer(wavs)
    want = jax_engine(variables, n, quantize="int8").infer(wavs)
    f1 = _f1(notes, want)
    print(f"int8 mesh of {n} vs JAX int8 mesh, {chunks} chunks: note F1 {f1:.4f}")
    assert sum(len(w["note_dur"]) for w in want) > 0
    assert [len(g["note_dur"]) for g in notes] == [len(w["note_dur"]) for w in want]
    for g, w in zip(notes, want):
        np.testing.assert_array_equal(g["note_rest"], w["note_rest"])
    assert f1 == 1.0


@pytest.mark.parametrize("wire", ["int16", "float32", "mulaw8", "mulaw12"])
def test_padding_rows_are_wire_silence(variables, wire):
    """pad_rows pads with ``silence_buffer`` rows, which decode to exact
    silence (mulaw8's code 128: a raw zero byte is full scale), and
    all-False masks, as the JAX engine's stage_inputs does; the mesh engine
    stages those rows."""
    n_samples = 128 * 512 - 1
    rows = silence_buffer(wire, 3, n_samples)
    rows[:, :4] = rows[:, 4:8] if wire == "mulaw12" else 7
    mask = np.ones((3, 128), bool)
    audio, padded_mask = pad_rows(rows, mask, 8, wire, n_samples)
    assert audio.shape == (8, rows.shape[1]) and audio.dtype == rows.dtype
    assert (audio[3:] == silence_buffer(wire, 5, n_samples)).all() and (audio[:3] == rows).all()
    assert padded_mask[:3].all() and not padded_mask[3:].any()
    decoded = decode_wire_device(torch.from_numpy(audio[3:]), wire, n_samples=n_samples)
    want = np.asarray(jax_decode_wire(jnp.asarray(audio[3:]), wire=wire, n_samples=n_samples))
    # silence to the wire's quantum (mu-law's code nearest 0 is 8.6e-5 off it)
    assert float(decoded.abs().max()) < 1e-4
    np.testing.assert_allclose(decoded.numpy(), want, rtol=1e-6, atol=0)
    if wire == "mulaw8":
        assert (audio[3:] == 128).all()
        zero_byte = decode_wire_device(torch.zeros((1, 8), dtype=torch.uint8), wire)
        assert (zero_byte == -1.0).all()
    assert pad_rows(rows, mask, 3, wire, n_samples)[0] is rows
    mesh = port_engine(variables, 2, transfer_dtype=wire)
    shards, mask_shards, _ = mesh.stage_inputs(audio[:3], mask)
    assert (shards[1][1].numpy() == audio[3]).all() and not mask_shards[1][1].any()


def test_wire_policy_is_one_for_the_mesh(variables, monkeypatch):
    """transfer_dtype auto on a mesh: one probe, on the first device, and a
    replica never probes; a re-probe that flips the wire flips every
    replica together (wire, hop, mel frontend, graphs dropped), and the
    notes still match the JAX mesh engine's on the half-rate wire."""
    from some_tpu_torch.inference.base_infer import BaseInference

    link, probes = {"mb_s": 1000.0}, []

    def probe(device, probe_mb=8.0):
        probes.append(device)
        return link["mb_s"]

    monkeypatch.setattr(BaseInference, "_probe_link_mb_s", staticmethod(probe))
    monkeypatch.setenv("SOME_TPU_WIRE_THRESHOLD_MB_S", "150")
    mesh = port_engine(variables, 2, transfer_dtype="auto", wire_probe_ttl_s=1e9)
    assert probes == [torch.device("cpu")]
    assert [(r.wire, r.wire_factor) for r in mesh.replicas] == [("int16", 1)] * 2
    assert mesh.replicas[1].wire_decision == mesh.wire_decision
    for r in mesh.replicas:
        r._graphs[("int16", 1, 128)] = "captured"  # a stand-in: the CPU captures none
    link["mb_s"] = 40.0
    mesh._wire_probe_time = -1e9
    got = mesh.infer(WAVS[3])
    assert len(probes) == 2
    assert [(r.wire, r.wire_factor, r.hop, r.mel.hop_length, r.graphs_captured)
            for r in mesh.replicas] == [("int16", 2, 256, 256, 0)] * 2
    want = jax_engine(variables, 2, transfer_dtype="int16", wire_sr=22050).infer(WAVS[3])
    assert_notes(got, want)


def test_mesh_helpers():
    """make_mesh's devices, validation and repeats; split_rows's shards;
    local_mesh_size."""
    mesh = make_mesh(["cpu"] * 3)
    assert mesh.size == 3 and mesh.axis_name == DATA_AXIS
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert local_mesh_size(mesh) == 3 and local_mesh_size() == 1
    with pytest.raises(ValueError, match="one type"):
        make_mesh(["cpu", "meta"])
    with pytest.raises(RuntimeError, match="not present"):
        make_mesh([torch.cuda.device_count()])
    x = np.arange(12).reshape(6, 2)
    shards = split_rows(x, 3)
    assert [s.tolist() for s in shards] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]],
                                            [[8, 9], [10, 11]]]
    with pytest.raises(ValueError, match="pad_rows first"):
        split_rows(x, 4)
    with pytest.raises(ValueError, match="first device"):
        MIDIExtractionInference(dict(CONFIG), None, device="cuda:0", mesh=mesh, state_dict={})


@pytest.mark.parametrize("n, shard_rows", [(2, (1, 2, 3, 4)), (8, (1,))])
def test_prewarm_builds_the_shard_buckets(variables, n, shard_rows):
    """prewarm pads each row bucket to the mesh and runs each shard bucket
    once on every replica: the shard-row programs that traffic then hits."""
    mesh = port_engine(variables, n)
    shapes = [[] for _ in mesh.replicas]
    for replica, seen in zip(mesh.replicas, shapes):
        pipeline = replica._device_pipeline

        def recording(audio, mask, pipeline=pipeline, seen=seen):
            seen.append(tuple(mask.shape))
            return pipeline(audio, mask)

        replica._device_pipeline = recording
    assert mesh.prewarm([128, 192]) == 2 * len(shard_rows)
    want = sorted((r, f) for f in (128, 192) for r in shard_rows)
    assert all(sorted(s) == want for s in shapes)
    assert [r.forwards for r in mesh.replicas] == [len(want)] * n


def test_infer_cli_two_devices_matches_the_jax_cli(tmp_path, songs):  # noqa: F811
    """``python -m some_tpu_torch.infer --device cpu --devices 2`` against
    ``infer.py --devices 2`` (the JAX mesh of two virtual CPU devices), in
    32-true: the notes equal."""
    from click.testing import CliRunner

    import infer as jax_cli
    from some_tpu_torch.infer import main as port_cli
    from tests.test_torch_infer import CONFIG as INFER_CONFIG

    v = jax_build(INFER_CONFIG).init(jax.random.PRNGKey(3), np.zeros((1, 32, 80), np.float32))
    ckpt = save_checkpoint(tmp_path, 1000, v["params"], v["batch_stats"])
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(dict(INFER_CONFIG,
                                                              pl_trainer_precision="32-true")))
    for i, wav in enumerate(songs):
        jax_mid, port_mid = tmp_path / f"jax{i}.mid", tmp_path / f"port{i}.mid"
        result = CliRunner().invoke(jax_cli.infer, ["--model", str(ckpt), "--wav", str(wav),
                                                    "--midi", str(jax_mid), "--devices", "2"])
        assert result.exit_code == 0, result.output
        port_cli(["--model", str(ckpt), "--wav", str(wav), "--midi", str(port_mid),
                  "--device", "cpu", "--devices", "2"])
        want = MidiFile.load(jax_mid).notes()
        assert len(want) > 0 and MidiFile.load(port_mid).notes() == want


def test_batch_infer_two_devices_matches_the_jax_cli(dataset_and_ckpt, tmp_path):  # noqa: F811
    """``batch_infer --devices 2`` (the port on two CPU replicas) against the
    JAX CLI's CSV with ``--devices 2``, in f32: note_seq equal, note_dur
    within 1e-6."""
    from click.testing import CliRunner

    import batch_infer as jax_bi
    from some_tpu_torch import batch_infer as port_bi

    dataset, ckpt = dataset_and_ckpt
    ckpt = shutil.copy(ckpt, tmp_path / ckpt.name)
    config = yaml.safe_load((dataset_and_ckpt[1].parent / "config.yaml").read_text())
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(dict(config,
                                                              pl_trainer_precision="32-true")))
    jax_csv, port_csv = tmp_path / "jax.csv", tmp_path / "port.csv"
    result = CliRunner().invoke(jax_bi.batch_infer, ["--dataset", str(dataset), "--model",
                                                     str(ckpt), "--csv", str(jax_csv),
                                                     "--devices", "2"])
    assert result.exit_code == 0, result.output
    port_bi.main(["--dataset", str(dataset), "--model", str(ckpt), "--csv", str(port_csv),
                  "--device", "cpu", "--devices", "2"])
    with open(jax_csv, newline="") as f:
        want = list(csv.DictReader(f))
    with open(port_csv, newline="") as f:
        got = list(csv.DictReader(f))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["note_seq"].split() == w["note_seq"].split() and g["note_seq"]
        np.testing.assert_allclose([float(d) for d in g["note_dur"].split()],
                                   [float(d) for d in w["note_dur"].split()], rtol=0, atol=1e-6)
