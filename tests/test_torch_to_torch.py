"""The port's weights back into the reference's PyTorch layout, and ``simplify``, on the CPU.

``some_tpu_torch.compat.to_torch`` against the JAX package's
``some_tpu.compat.to_torch`` on the same JAX variables (key for key, bit for
bit); a reference Lightning file through the port and back (exact, and a
strict load into tests/torch_oracle.py's ``OracleModel``); the first-party
torch model of ``compat/torch_model.py`` against the port's own modules; and
``simplify`` on a port training checkpoint, a native JAX one and a Lightning
one, whose simplified files the port's infer CLI serves to the same MIDI
bytes. The geometry is tests/test_torch_infer.py's (2 layers, dim 64).
"""
import jax
import numpy as np
import optax
import pytest
import torch
import yaml

from some_tpu.compat.to_torch import backbone_to_torch_state_dict as jax_to_torch
from some_tpu.nn.model import build_midi_extractor as jax_build
from some_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from some_tpu_torch.audio.wavio import save_wav
from some_tpu_torch.compat.from_jax import jax_params_to_state_dict
from some_tpu_torch.compat.to_torch import backbone_to_torch_state_dict, save_torch_checkpoint
from some_tpu_torch.compat.torch_ckpt import reference_state_dict
from some_tpu_torch.compat.torch_model import load_from_state_dict
from some_tpu_torch.infer import main as infer_main
from some_tpu_torch.nn.model import build_midi_extractor
from some_tpu_torch.utils.checkpoint import (
    FORMAT, load_checkpoint, load_state_dict, save_checkpoint, simplify_checkpoint,
)
from tests.test_inference import synth
from tests.test_torch_ckpt import lightning_payload, oracle
from tests.test_torch_infer import CONFIG
from tests.torch_oracle import OracleModel

ARGS = CONFIG["midi_extractor_args"]


@pytest.fixture(scope="module")
def variables():
    v = jax_build(CONFIG).init(jax.random.PRNGKey(3), np.zeros((1, 32, 80), np.float32))
    rng = np.random.default_rng(4)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32), v["batch_stats"])
    return {"params": jax.tree_util.tree_map(np.asarray, v["params"]), "batch_stats": stats}


def test_matches_the_jax_converter_key_for_key(variables):
    want = jax_to_torch(variables["params"], variables["batch_stats"])
    got = backbone_to_torch_state_dict(
        jax_params_to_state_dict(variables["params"], variables["batch_stats"]))
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].numpy().dtype == value.dtype, key
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_lightning_round_trip_is_exact_and_loads_strictly(tmp_path):
    """Lightning ``state_dict`` -> the port's -> the reference's: every key
    and value of the original (``num_batches_tracked`` 0 as written), and a
    strict load into a fresh ``OracleModel``; ``save_torch_checkpoint``
    writes a file the port reads back to the same weights."""
    model = oracle(11)
    original = model.state_dict()
    port = reference_state_dict(lightning_payload(model))
    back = backbone_to_torch_state_dict(port)
    assert set(back) == set(original)
    for key, value in original.items():
        assert back[key].dtype == value.dtype, key
        assert torch.equal(back[key], value), key
    fresh = OracleModel(ARGS["lay"], ARGS["dim"], CONFIG["units_dim"], CONFIG["midi_num_bins"],
                        kernel_size=ARGS["kernel_size"], heads=ARGS["attention_heads"],
                        dim_head=ARGS["attention_heads_dim"])
    fresh.load_state_dict(back, strict=True)

    save_torch_checkpoint(port, tmp_path / "model.ckpt")
    payload = torch.load(tmp_path / "model.ckpt", weights_only=True)
    assert all(k.startswith("model.model.") for k in payload["state_dict"])
    again = load_checkpoint(tmp_path / "model.ckpt")
    assert again["format"] == "torch-converted"
    assert set(again["state_dict"]) == set(port)
    assert all(torch.equal(again["state_dict"][k], v) for k, v in port.items())


@pytest.mark.parametrize("key,value", [
    ("backbone.in_proj_midi.weight", torch.zeros(4, 4, dtype=torch.int8)),
    ("backbone.in_proj_midi.weight_scale", torch.ones(4)),
    ("backbone.layer_0.midi_block.conv.dw.kernel", torch.ones(4)),
    ("backbone.layer_0.midi_gate.extra.weight", torch.ones(4)),
    ("decoder.weight", torch.ones(4)),
])
def test_unmapped_or_quantized_keys_raise(key, value):
    with pytest.raises(KeyError):
        backbone_to_torch_state_dict({key: value})


def test_torch_model_matches_the_port_model(variables):
    """The reference-layout torch model on the port's weights against the
    port's own modules in f32 eval mode (the tolerance of the JAX bridge's
    test against flax, tests/test_onnx_export.py)."""
    state = jax_params_to_state_dict(variables["params"], variables["batch_stats"])
    port = build_midi_extractor(CONFIG, dtype=torch.float32).eval()
    port.load_state_dict(state, strict=True)
    ref = load_from_state_dict(CONFIG, state)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 96, 80), np.float32))
    mask = torch.ones(2, 96, dtype=torch.bool)
    with torch.no_grad():
        want = port(x, mask=mask, sig=True)
        got = ref(x, mask=mask, sig=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=5e-4)


def _optimizer_state(state):
    """An AdamW state after one step on the port model holding ``state``."""
    model = build_midi_extractor(CONFIG)
    model.load_state_dict(state, strict=True)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    sum(p.sum() for p in model.parameters()).backward()
    opt.step()
    return model.state_dict(), opt.state_dict()


@pytest.mark.parametrize("source", ["port", "jax", "lightning"])
def test_simplify(variables, tmp_path, source):
    """Each checkpoint the port reads becomes a port checkpoint with no
    optimizer state, its meta and weights as they were, which the infer CLI
    serves to the same MIDI bytes as the source."""
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(dict(CONFIG,
                                                              pl_trainer_precision="32-true")))
    if source == "port":
        state, opt = _optimizer_state(
            jax_params_to_state_dict(variables["params"], variables["batch_stats"]))
        meta = {"step": 7, "micro_step": 7, "epoch": 1, "epoch_batch": 2}
        src = save_checkpoint(tmp_path / "model_ckpt_steps_7.ckpt", state, meta, opt,
                              {"mini_step": 1, "grads": {k: torch.ones(1) for k in state}})
    elif source == "jax":
        src = jax_save_checkpoint(tmp_path, 1000, variables["params"],
                                  variables["batch_stats"],
                                  optax.adam(1e-3).init(variables["params"]))
        meta = {"format": "some-tpu-v1", "step": 1000}
    else:
        src = tmp_path / "model.ckpt"
        torch.save(lightning_payload(oracle(13)), src)
        meta = {"step": 0}
    out = simplify_checkpoint(src, tmp_path / "simple.ckpt")
    payload = load_checkpoint(out)
    assert payload["format"] == FORMAT
    assert payload["optimizer"] is None and payload["accumulator"] is None
    assert payload["meta"] == meta
    want = load_state_dict(src)
    assert set(payload["state_dict"]) == set(want)
    assert all(torch.equal(payload["state_dict"][k], v) for k, v in want.items())

    wav = tmp_path / "song.wav"
    save_wav(wav, np.concatenate([synth(1.2, 440, seed=1), np.zeros(22050, np.float32),
                                  synth(1.5, 330, seed=2)]), CONFIG["audio_sample_rate"])
    for ckpt, midi in ((src, "source.mid"), (out, "simple.mid")):
        infer_main(["--model", str(ckpt), "--wav", str(wav), "--midi", str(tmp_path / midi),
                    "--device", "cpu"])
    assert (tmp_path / "source.mid").read_bytes() == (tmp_path / "simple.mid").read_bytes()
