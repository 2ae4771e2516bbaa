"""The port's ONNX bridge against the JAX package's, on the CPU.

The same weights (the JAX bridge's tests' ``MidiExtractor.init`` at
tests/test_inference.py's tiny geometry, carried across by
``compat/from_jax``) go through ``some_tpu_torch.deployment.onnx_export``
and ``some_tpu.deployment.onnx_export``: the eager modules agree bit for bit,
the two exported ``.onnx`` files have equal structural summaries (op
inventory included), and the port's numpy executor runs the port's graph to
the eager module's notes, with the tolerances of tests/test_onnx_export.py.
The port's reader and executor agree with the JAX package's copies on the
same file. Neither needs the ``onnx`` package or onnxruntime.
"""
import numpy as np
import pytest
import torch

from some_tpu.deployment import onnx_export as jax_ox
from some_tpu.deployment.onnx_inspect import read_model_summary as jax_summary
from some_tpu.deployment.onnx_run import run_graph as jax_run_graph
from some_tpu_torch.compat.from_jax import jax_params_to_state_dict
from some_tpu_torch.config import save_yaml
from some_tpu_torch.deployment import onnx_export as ox
from some_tpu_torch.deployment.onnx_inspect import read_model_summary
from some_tpu_torch.deployment.onnx_run import run_graph
from some_tpu_torch.export import main as export_main
from some_tpu_torch.utils.checkpoint import save_checkpoint
from tests.test_inference import TINY_MODEL_CONFIG, synth

DISCRETE = dict(TINY_MODEL_CONFIG, midi_num_bins=129,
                task_cls="training.QuantizedMIDIExtractionTask")
TASKS = {"continuous": (TINY_MODEL_CONFIG, 7, (1.5, 440.0, 3)),
         "discrete": (DISCRETE, 8, (1.0, 330.0, 4))}


@pytest.fixture(scope="module", params=sorted(TASKS))
def task(request):
    """(config, JAX variables, port state_dict, waveform) of one task, the
    JAX bridge's tests' seeds and songs."""
    import jax

    from some_tpu.nn.model import build_midi_extractor

    config, seed, (seconds, freq, song_seed) = TASKS[request.param]
    variables = build_midi_extractor(dict(config)).init(
        jax.random.PRNGKey(seed), np.zeros((1, 64, 80), np.float32),
        mask=np.ones((1, 64), bool))
    state = jax_params_to_state_dict(variables["params"], variables["batch_stats"])
    return dict(config), variables, state, synth(seconds, freq=freq, seed=song_seed)


@pytest.fixture(scope="module")
def exported(task, tmp_path_factory):
    """Both bridges' ``.onnx`` files of the task's weights."""
    config, variables, state, _ = task
    d = tmp_path_factory.mktemp("onnx")
    ox.export_onnx(config, state, d / "port.onnx")
    jax_ox.export_onnx(config, variables, d / "jax.onnx")
    return d / "port.onnx", d / "jax.onnx"


def test_module_matches_the_jax_bridge_bit_for_bit(task):
    config, variables, state, wav = task
    port = ox.build_onnx_module(config, state)
    ref = jax_ox.build_onnx_module(config, variables)
    with torch.no_grad():
        got = port(torch.from_numpy(wav[None]))
        want = ref(torch.from_numpy(wav[None]))
    assert got[0].shape[1] > 0
    for name, g, w in zip(("note_midi", "note_rest", "note_dur"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


def test_exported_graph_has_the_jax_bridges_summary(exported):
    """Opset 17, the I/O names and dynamic axes, every load-bearing op, and
    the whole op inventory equal to the JAX bridge's file; the port's reader
    and the JAX package's read the port's file alike."""
    port_file, jax_file = exported
    s = read_model_summary(port_file)
    assert s["opset"] == 17
    assert [name for name, _ in s["inputs"]] == ["waveform"]
    assert [name for name, _ in s["outputs"]] == ["note_midi", "note_rest", "note_dur"]
    assert s["inputs"][0][1][1] == "n_samples"
    assert all(dims[1] == "n_notes" for _, dims in s["outputs"])
    for required in ("STFT", "Conv", "MatMul", "LayerNormalization", "Sigmoid", "CumSum",
                     "ScatterElements", "ArgMax"):
        assert s["op_types"][required] > 0, required
    assert s == jax_summary(jax_file)
    assert s == jax_summary(port_file)


def test_numpy_executor_runs_the_graph_to_the_eager_notes(task, exported):
    """The port's executor on the port's file against the eager module
    (tests/test_onnx_export.py's tolerances), and equal to the JAX
    package's executor on the same file."""
    config, _, state, wav = task
    port_file, _ = exported
    module = ox.build_onnx_module(config, state)
    with torch.no_grad():
        want = [t.numpy() for t in module(torch.from_numpy(wav[None]))]
    got = run_graph(port_file, {"waveform": wav[None]})
    assert got[0].shape == want[0].shape and got[0].shape[1] > 0
    np.testing.assert_allclose(got[0], want[0], atol=1e-4)
    np.testing.assert_array_equal(got[1].astype(bool), want[1].astype(bool))
    np.testing.assert_allclose(got[2], want[2], atol=1e-6)
    for g, j in zip(got, jax_run_graph(port_file, {"waveform": wav[None]})):
        assert g.dtype == j.dtype
        np.testing.assert_array_equal(g, j)


def test_export_cli_onnx(task, exported, tmp_path):
    """``python -m some_tpu_torch.export --format onnx`` from a port
    checkpoint writes the graph ``export_onnx`` writes."""
    config, _, state, _ = task
    save_yaml(config, tmp_path / "config.yaml")
    ckpt = save_checkpoint(tmp_path / "model.ckpt", state, {"step": 1})
    export_main(["--model", str(ckpt), "--format", "onnx", "--out", str(tmp_path / "m.onnx")])
    assert read_model_summary(tmp_path / "m.onnx") == read_model_summary(exported[0])


def test_onnx_patch_is_version_gated(monkeypatch):
    """The private-API patch refuses an unverified torch."""
    try:
        import onnx  # noqa: F401
        pytest.skip("onnx installed: the patch path is never taken")
    except ImportError:
        pass
    monkeypatch.setattr(torch, "__version__", "2.99.0")
    with pytest.raises(RuntimeError, match="only verified on torch"):
        ox._patch_missing_onnx_package()
