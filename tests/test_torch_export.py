"""The port's deployment export (``torch.export`` programs per bucket) and its
kernel ops, on the CPU.

At tests/test_inference.py's tiny geometry, in f32, with weights from the
JAX init carried across by ``compat/from_jax``: the port's programs at
buckets 128 and 256, traced and loaded with ``device="cpu"``, against the
JAX package's StableHLO programs exported and loaded as
tests/test_inference.py does it (notes F1 1.0, equal counts and durations,
``note_midi`` within 1e-4); each program against the port engine's
``_device_pipeline`` bit for bit; the manifest; the export CLI, which
pins the native-rate float32 wire; the discrete task and the int8 engine;
and the four kernel ops of ``ops/library.py`` (``torch.library.opcheck`` on CPU
samples, and the model's inference calls going through them). The programs
run the ops' plain versions here; tests/test_torch_export_gpu.py runs them
on the card.
"""
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from some_tpu.inference.me_infer import MIDIExtractionInference as JaxEngine
from some_tpu.inference.me_quant_infer import QuantizedMIDIExtractionInference as JaxQuantEngine
from some_tpu.nn.model import build_midi_extractor as jax_build
from some_tpu.utils.note_f1 import note_f1
from some_tpu_torch.compat.from_jax import jax_params_to_state_dict
from some_tpu_torch.config import save_yaml
from some_tpu_torch.deployment.export import (
    FORMAT, MIDIExtractionExporter, QuantizedMIDIExtractionExporter, load_exported,
)
from some_tpu_torch.nn.conformer import set_dropout_step
from some_tpu_torch.nn.model import build_midi_extractor
from some_tpu_torch.ops import library
from some_tpu_torch.utils.checkpoint import save_checkpoint
from tests.test_inference import TINY_MODEL_CONFIG, synth
from tests.test_torch_infer import REPO

CONFIG = dict(TINY_MODEL_CONFIG, pl_trainer_precision="32-true")
DISCRETE = dict(CONFIG, midi_num_bins=129, task_cls="training.QuantizedMIDIExtractionTask")
BUCKETS = (128, 256)
# about 0.9 s (78 frames: bucket 128) and 2.6 s (224 frames: bucket 256)
WAVES = ((0.9, 440.0, 1), (2.6, 392.0, 2))
JAX_MANIFEST_KEYS = {"format", "task_cls", "sample_rate", "hop_size", "timestep", "buckets"}


def jax_variables(config, seed):
    v = jax_build(config).init(jax.random.PRNGKey(seed), np.zeros((1, 64, 80), np.float32),
                               mask=np.ones((1, 64), bool))
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32), v["batch_stats"])
    return {"params": jax.tree_util.tree_map(np.asarray, v["params"]), "batch_stats": stats}


def state_dict_of(variables):
    return jax_params_to_state_dict(variables["params"], variables["batch_stats"])


@pytest.fixture(scope="module")
def variables():
    return jax_variables(CONFIG, 0)


@pytest.fixture(scope="module")
def artifact(variables, tmp_path_factory):
    """The port's artifact at buckets 128 and 256, traced on the CPU: its
    directory, its exporter and the loaded pipeline."""
    out = tmp_path_factory.mktemp("pt2")
    exporter = MIDIExtractionExporter(CONFIG, state_dict=state_dict_of(variables), device="cpu")
    exporter.export(out, buckets=BUCKETS)
    return out, exporter, load_exported(out, device="cpu")


def bucket_inputs(wave, bucket, hop=512):
    audio = np.zeros((1, bucket * hop - 1), np.float32)
    audio[0, :len(wave)] = wave
    mask = np.zeros((1, bucket), bool)
    mask[0, :len(wave) // hop + 1] = True
    return audio, mask


def events(notes):
    off = np.cumsum(notes["note_dur"])
    keep = ~np.asarray(notes["note_rest"], bool)
    return (off - notes["note_dur"])[keep], off[keep], np.asarray(notes["note_midi"], float)[keep]


def test_programs_give_the_jax_stablehlo_notes(variables, artifact, tmp_path):
    """The JAX package's programs of the same buckets, exported for the CPU
    and loaded by ``some_tpu.deployment.export.load_exported`` (as
    tests/test_inference.py builds them), against the port's."""
    from jax import export as jexport

    from some_tpu.deployment.export import load_exported as jax_load_exported

    engine = JaxEngine.from_variables(dict(CONFIG, transfer_dtype="float32"), variables,
                                      dtype=jnp.float32)
    params = jax.device_put(engine.variables)
    manifest = {}
    for bucket in BUCKETS:
        n_samples = bucket * engine.hop - 1
        exported = jexport.export(
            jax.jit(lambda a, m: engine._device_pipeline(params, a, m)), platforms=["cpu"])(
            jax.ShapeDtypeStruct((1, n_samples), np.float32),
            jax.ShapeDtypeStruct((1, bucket), np.bool_))
        (tmp_path / f"bucket_{bucket}.stablehlo").write_bytes(exported.serialize())
        manifest[str(bucket)] = {"file": f"bucket_{bucket}.stablehlo", "n_samples": n_samples,
                                 "frames": bucket}
    (tmp_path / "manifest.json").write_text(json.dumps({
        "format": "some-tpu-stablehlo-v1", "sample_rate": 44100, "hop_size": engine.hop,
        "timestep": engine.timestep, "buckets": manifest}))
    want_pipeline = jax_load_exported(tmp_path)
    got_pipeline = artifact[2]
    for seconds, freq, seed in WAVES:
        wave = synth(seconds, freq, seed=seed)
        got, want = got_pipeline(wave), want_pipeline(wave)
        assert len(want["note_dur"]) > 0
        np.testing.assert_array_equal(got["note_rest"], want["note_rest"])
        np.testing.assert_array_equal(got["note_dur"], want["note_dur"])
        np.testing.assert_allclose(got["note_midi"], want["note_midi"], rtol=0, atol=1e-4)
        f1 = note_f1(events(want), events(got), onset_tolerance=0.05, pitch_tolerance=0.5)
        assert f1.f1 == 1.0, f1


def test_programs_equal_the_engine_pipeline_bit_for_bit(artifact):
    _, exporter, pipeline = artifact
    assert sorted(pipeline.programs) == list(BUCKETS)
    for (seconds, freq, seed), bucket in zip(WAVES, BUCKETS):
        audio, mask = bucket_inputs(synth(seconds, freq, seed=seed), bucket)
        got = pipeline.run_bucket(audio, mask)
        with torch.inference_mode():
            want = exporter.engine._device_pipeline(torch.from_numpy(audio),
                                                    torch.from_numpy(mask))
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


def test_manifest(artifact):
    out_dir, exporter, _ = artifact
    manifest = json.loads((out_dir / "manifest.json").read_text())
    assert JAX_MANIFEST_KEYS <= set(manifest)
    assert manifest["format"] == FORMAT and manifest["device"] == "cpu"
    assert manifest["dtype"] == "float32" and manifest["torch"] == torch.__version__
    assert manifest["hop_size"] == 512 and manifest["sample_rate"] == 44100
    assert manifest["timestep"] == exporter.engine.timestep
    assert manifest["buckets"] == {str(b): {"file": f"bucket_{b}.pt2", "n_samples": b * 512 - 1,
                                            "frames": b} for b in BUCKETS}
    with pytest.raises(ValueError, match="traced on cpu"):
        load_exported(out_dir, device="cuda")


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_discrete_task_and_int8_engine(tmp_path, quantize):
    """The discrete task through ``QuantizedMIDIExtractionExporter`` (its
    program equal to its engine's pipeline bit for bit, its notes the JAX
    discrete engine's); and the int8 engine, which exports with its int8
    weights and ``torch._int_mm`` products."""
    config = dict(DISCRETE, quantize=quantize)
    variables = jax_variables(DISCRETE, 8)
    exporter = QuantizedMIDIExtractionExporter(config, state_dict=state_dict_of(variables),
                                               device="cpu")
    exporter.export(tmp_path, buckets=(128,))
    pipeline = load_exported(tmp_path, device="cpu")
    wave = synth(0.9, 440.0, seed=1)
    audio, mask = bucket_inputs(wave, 128)
    got = pipeline.run_bucket(audio, mask)
    with torch.inference_mode():
        want = exporter.engine._device_pipeline(torch.from_numpy(audio), torch.from_numpy(mask))
    assert all(torch.equal(got[k], want[k]) for k in want)
    code = pipeline.programs[128].code
    assert ("torch.ops.aten._int_mm" in code) == (quantize == "int8")
    if quantize == "none":
        jax_engine = JaxQuantEngine.from_variables(dict(DISCRETE, transfer_dtype="float32"),
                                                   variables, dtype=jnp.float32)
        jax_notes = jax_engine.infer([wave])[0]
        notes = pipeline(wave)
        np.testing.assert_array_equal(notes["note_rest"], jax_notes["note_rest"])
        np.testing.assert_array_equal(notes["note_dur"], jax_notes["note_dur"])
        np.testing.assert_allclose(notes["note_midi"], jax_notes["note_midi"], atol=1e-4)


def test_export_cli_pins_native_rate_float32_wire(variables, artifact, tmp_path):
    """``python -m some_tpu_torch.export --device cpu`` on a port checkpoint
    whose config carries serving knobs (``wire_sr: 22050``, ``transfer_dtype:
    mulaw12``): the exporter pins the native-rate float32 wire, as
    tests/test_onnx_export.py holds for the JAX exporter, so the program
    takes native-rate float32 audio and gives the in-process export's
    outputs bit for bit."""
    config = dict(CONFIG, wire_sr=22050, transfer_dtype="mulaw12")
    engine = MIDIExtractionExporter(config, state_dict=state_dict_of(variables),
                                    device="cpu").engine
    assert (engine.wire_factor, engine.wire, engine.hop) == (1, "float32", CONFIG["hop_size"])
    save_yaml(config, tmp_path / "config.yaml")
    ckpt = save_checkpoint(tmp_path / "model.ckpt", state_dict_of(variables), {"step": 1})
    proc = subprocess.run([sys.executable, "-m", "some_tpu_torch.export", "--model", str(ckpt),
                           "--buckets", "128", "--device", "cpu"],
                          capture_output=True, text=True, timeout=300, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "torch.export artifact saved" in proc.stdout
    got = load_exported(tmp_path / "model.pt2", device="cpu")
    manifest = json.loads((tmp_path / "model.pt2" / "manifest.json").read_text())
    assert manifest["hop_size"] == CONFIG["hop_size"]
    assert manifest["buckets"]["128"]["n_samples"] == 128 * CONFIG["hop_size"] - 1
    audio, mask = bucket_inputs(synth(0.9, 440.0, seed=1), 128)
    a, b = got.run_bucket(audio, mask), artifact[2].run_bucket(audio, mask)
    assert all(torch.equal(a[k], b[k]) for k in b)


def op_samples(dtype=torch.float32):
    gen = torch.Generator().manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=gen).to(dtype)  # noqa: E731
    q, k, v = (randn(2, 2, 24, 32) for _ in range(3))
    mask = torch.arange(24)[None, :] < torch.tensor([[24], [17]])
    D, H = 64, 256
    ffn = (randn(3, 20, D), 1.0 + 0.1 * randn(D), 0.1 * randn(D), randn(D, H) * D ** -0.5,
           0.1 * randn(H), randn(H, D) * H ** -0.5, 0.1 * randn(D), 1e-5, 0.5)
    return {"depthwise_conv1d": [(randn(2, 40, 16), randn(7, 16)),
                                 (randn(1, 9, 5), randn(31, 5))],
            "flash_attention": [(q, k, v, mask, 32 ** -0.5), (q, k, v, None, 0.25)],
            "splash_attention": [(q, k, v, mask, 32 ** -0.5), (q, k, v, None, 0.25)],
            "fused_ln_ffn_residual": [ffn]}


@pytest.mark.parametrize("name", ["depthwise_conv1d", "flash_attention", "splash_attention",
                                  "fused_ln_ffn_residual"])
def test_opcheck(name):
    """``torch.library.opcheck`` (schema, fake implementation, autograd
    registration, dynamic shapes) on CPU samples, inputs needing no
    gradient; and each op equals its plain version there."""
    library.register_fakes()
    op = getattr(torch.ops.some_tpu, name).default
    plain = library.IMPLS[name][0]
    for dtype in (torch.float32, torch.bfloat16):
        for args in op_samples(dtype)[name]:
            torch.library.opcheck(op, args)
            assert torch.equal(op(*args), plain(*args))


def test_first_op_calls_stay_cheap():
    """A fresh process's first calls of the ops (an infer CLI's first
    transcription) import nothing of ``torch._dynamo`` and never call
    ``inspect.getmodule``: the ops are registered per dispatch key, not
    through ``torch.library.custom_op`` (whose wrappers import
    ``torch._dynamo`` on their first call), and their fakes only for
    tracing (``register_fake`` looks its caller up with
    ``inspect.getmodule``, which walks every loaded module's path); both
    cost a cold CLI seconds on the card's host."""
    code = ("import inspect, sys, torch\n"
            "calls = []\n"
            "getmodule = inspect.getmodule\n"
            "inspect.getmodule = lambda *a, **k: calls.append(a) or getmodule(*a, **k)\n"
            "from some_tpu_torch.ops import custom_ops\n"
            "x, w, q = torch.randn(1, 9, 64), torch.randn(7, 64), torch.randn(1, 2, 9, 32)\n"
            "ffn = [torch.ones(64), torch.zeros(64), torch.randn(64, 256), torch.zeros(256),\n"
            "       torch.randn(256, 64), torch.zeros(64)]\n"
            "with torch.inference_mode():\n"
            "    custom_ops().depthwise_conv1d(x, w)\n"
            "    custom_ops().flash_attention(q, q, q, None, 0.1)\n"
            "    custom_ops().splash_attention(q, q, q, None, 0.1)\n"
            "    custom_ops().fused_ln_ffn_residual(x, *ffn, 1e-5, 0.5)\n"
            "print(len(calls), sorted(m for m in sys.modules if m.startswith('torch._dynamo')))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "0 []", proc.stdout


class OpCounter(TorchDispatchMode):
    """Counts the ``some_tpu`` ops dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "some_tpu":
            name = func.__name__.split(".")[0]
            self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("opt_in", [False, True])
def test_inference_goes_through_the_ops(variables, opt_in):
    """A port model's inference forward calls ``torch.ops.some_tpu.*`` once a
    block for each kernel of its configuration (and twice for the fused
    FFN); a forward that needs gradients calls none."""
    config = dict(CONFIG, **({"fuse_ffn": True, "attention_impl": "splash"} if opt_in else {}))
    model = build_midi_extractor(config, dtype=torch.float32).eval()
    model.load_state_dict(state_dict_of(variables), strict=True)
    blocks = 2 * CONFIG["midi_extractor_args"]["lay"] + 2
    want = ({"depthwise_conv1d": blocks, "splash_attention": blocks,
             "fused_ln_ffn_residual": 2 * blocks} if opt_in else
            {"depthwise_conv1d": blocks, "flash_attention": blocks})
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 40, 80), np.float32))
    mask = torch.arange(40)[None] < torch.tensor([[40], [31]])
    with torch.inference_mode(), OpCounter() as counter:
        out = model(x, mask=mask, sig=True)
    assert counter.counts == want
    with torch.no_grad(), OpCounter() as counter:
        assert torch.equal(model(x, mask=mask, sig=True)[0], out[0])
    assert counter.counts == want
    model.train()
    set_dropout_step(model, 0, 0)
    with OpCounter() as counter:
        model(x, mask=mask)[0].sum().backward()
    assert counter.counts == {}
