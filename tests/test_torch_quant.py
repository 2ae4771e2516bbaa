"""Int8 serving (``quantize: int8``) of the PyTorch port against the JAX
package's, on the CPU.

The primitives of ``some_tpu_torch/ops/quant.py`` are held bit for bit
against ``some_tpu/ops/quant.py`` on seeded numpy inputs; the quantized
model and engine at a small geometry (2 layers, dim 64) against the JAX
int8 model and engine with the same weights. On the card the int8 product
is ``torch._int_mm`` (cuBLASLt); tests/test_torch_kernels_gpu.py holds it
against an exact product there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from some_tpu.inference.me_infer import MIDIExtractionInference as JaxEngine
from some_tpu.nn.model import MidiExtractor as JaxModel
from some_tpu.ops import quant as jax_quant
from some_tpu_torch.compat.from_jax import (
    jax_params_to_state_dict, jax_variable_shapes, load_jax_variables,
)
from some_tpu_torch.inference.me_infer import MIDIExtractionInference
from some_tpu_torch.nn import conformer
from some_tpu_torch.nn.model import MidiExtractor, build_midi_extractor
from some_tpu_torch.ops import quant
from some_tpu_torch.utils.note_f1 import note_f1
from tests.test_prod_parity import make_song
from tests.test_torch_infer import CONFIG

GEOMETRY = dict(lay=2, dim=64, indim=16, outdim=32, kernel_size=7, attention_heads=2,
                attention_heads_dim=32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _stats(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32),
                                  tree)


@pytest.fixture(scope="module")
def variables():
    v = _np(JaxModel(**GEOMETRY).init(jax.random.PRNGKey(0), np.zeros((1, 8, 16), np.float32)))
    return {"params": v["params"], "batch_stats": _stats(v["batch_stats"], 1)}


# ---- the primitives, bit for bit ----

@pytest.mark.parametrize("shape,zero_column", [((64, 96), False), ((32, 256), True),
                                               ((512, 8), False)])
def test_quantize_weight_matches_jax(shape, zero_column):
    w = (np.random.default_rng(shape[0]).standard_normal(shape) * 0.05).astype(np.float32)
    if zero_column:
        w[:, 3] = 0.0  # amax 0: scale 1, codes 0
    q, scale = quant.quantize_weight(w)
    jq, jscale = jax_quant.quantize_weight(w)
    assert q.dtype == np.int8 and scale.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(scale, jscale)


@pytest.mark.parametrize("shape,scale,dtype", [((4, 33, 64), 3.0, "float32"),
                                               ((2, 7, 32), 1e-3, "float32"),
                                               ((3, 50, 64), 20.0, "bfloat16"),
                                               ((2, 16, 32), 0.0, "float32")])
def test_quantize_activation_matches_jax(shape, scale, dtype):
    """Codes and the scale bit for bit, an all-zero tensor (scale 1e-8)
    included; round half to even on both sides."""
    x = (np.random.default_rng(7).standard_normal(shape) * scale).astype(np.float32)
    x.flat[:4] = np.array([0.5, 1.5, -2.5, 126.5], np.float32) * (scale or 1) / 127
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want_q, want_s = jax_quant.quantize_activation(jx)
    got_q, got_s = quant.quantize_activation(torch.from_numpy(np.asarray(jx, np.float32))
                                             .to(getattr(torch, dtype)))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32 and got_s.dim() == 0
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert got_s.item() == float(want_s)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_matmul_and_dense_match_jax(out_dtype):
    """int8_matmul on the same codes and dynamic_int8_dense on the same
    input: bit for bit in f32 and in bf16 (one f32 rescale, one rounding)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 41, 64)) * 2).astype(np.float32)
    wq, sw = jax_quant.quantize_weight((rng.standard_normal((64, 96)) * 0.05).astype(np.float32))
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    xq, sx = jax_quant.quantize_activation(jnp.asarray(x))
    want = np.asarray(jax_quant.int8_matmul(xq, sx, jnp.asarray(wq), jnp.asarray(sw), jdt),
                      np.float32)
    w_port = torch.from_numpy(np.ascontiguousarray(wq.T))  # [out, in]
    got = quant.int8_matmul(torch.from_numpy(np.asarray(xq)), torch.tensor(float(sx)), w_port,
                            torch.from_numpy(sw), tdt)
    assert got.dtype == tdt and got.shape == (3, 41, 96)
    np.testing.assert_array_equal(got.float().numpy(), want)
    want = np.asarray(jax_quant.dynamic_int8_dense(jnp.asarray(x), jnp.asarray(wq),
                                                   jnp.asarray(sw), jdt), np.float32)
    got = quant.dynamic_int8_dense(torch.from_numpy(x), w_port, torch.from_numpy(sw), tdt)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_quantize_params_matches_jax(variables):
    """The same modules quantized as JAX's kernels (mapped by name), with
    the same codes and scales; the quantized model's variable tree is JAX's
    quantized tree, qscales included."""
    jparams, jscales = jax_quant.quantize_params(variables["params"])
    model = MidiExtractor(**GEOMETRY, quant="int8")
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    assert quant.quantize_params(model) == 58  # 6 blocks x 9 products + 4 gates
    assert quant.quantize_params(model) == 0  # idempotent
    want = jax_params_to_state_dict(jparams, variables["batch_stats"], jscales)
    got = model.state_dict()
    assert set(got) == set(want)
    int8 = sorted(k for k, t in got.items() if t.dtype == torch.int8)
    assert int8 == sorted(k for k, t in want.items() if t.dtype == torch.int8)
    assert "backbone.layer_0.midi_gate.weight" in int8
    assert "backbone.final_bound.attn.out_proj.weight" in int8
    for kept in ("backbone.out_proj.weight", "backbone.bound_head.weight",
                 "backbone.in_proj_midi.weight", "backbone.layer_1.bound_block.conv.dw.weight"):
        assert got[kept].dtype == torch.float32, kept
    for key in got:
        assert torch.equal(got[key], want[key]), key
    assert jax_variable_shapes(model) == jax.tree_util.tree_map(
        lambda a: tuple(np.shape(a)), {"params": jparams, "batch_stats": variables["batch_stats"],
                                       "qscales": jscales})


@pytest.mark.parametrize("dtype,seed", [("float32", 1), ("float32", 2), ("bfloat16", 2)])
def test_int8_model_matches_jax(variables, dtype, seed):
    """Probs and bounds of the int8 model against JAX's int8 model (jitted)
    on a padded batch with a padding row: max |d| <= 0.05 and mean |d| <=
    0.01. Not tighter: where an activation lands on a .5 code boundary, the
    two frameworks' f32 values one ulp apart round to neighbouring codes,
    and the per-tensor amax carries that flip into every row of the next
    products (measured over 8 seeds in f32: max 0.038, mean 0.006; seed 1
    flips nothing and agrees to 2.4e-7, seed 2 flips)."""
    jparams, jscales = jax_quant.quantize_params(variables["params"])
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 40, 16)).astype(np.float32)
    mask = np.ones((3, 40), bool)
    mask[1, 25:] = False
    mask[2] = False
    jm = JaxModel(**GEOMETRY, quant="int8", dtype=getattr(jnp, dtype))
    want = jax.jit(lambda v, x, m: jm.apply(v, x, mask=m, sig=True))(
        {"params": jparams, "batch_stats": variables["batch_stats"], "qscales": jscales}, x, mask)
    model = MidiExtractor(**GEOMETRY, quant="int8", dtype=getattr(torch, dtype)).eval()
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    quant.quantize_params(model)
    with torch.no_grad():
        got = model(torch.from_numpy(x), mask=torch.from_numpy(mask), sig=True)
    for g, w in zip(got, want):
        d = np.abs(g.float().numpy() - np.asarray(w, np.float32))
        print(f"parity int8 model {dtype} seed {seed}: max|d| {d.max():.3g} mean {d.mean():.3g}")
        assert np.isfinite(g.float().numpy()).all()
        assert d.max() <= 0.05 and d.mean() <= 0.01


def test_int8_never_fuses_ffn(variables, monkeypatch):
    """``fuse_ffn`` with int8 runs the unfused, quantized FFNs (K3 reads f32
    weights), as JAX's ``_macaron_ffn`` gates it."""
    config = {"units_dim": 16, "midi_num_bins": 32, "fuse_ffn": True, "quantize": "int8",
              "midi_extractor_args": {k: v for k, v in GEOMETRY.items()
                                      if k not in ("indim", "outdim")}}
    model = build_midi_extractor(config).eval()
    assert model.quant == "int8"
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    quant.quantize_params(model)
    monkeypatch.setattr(conformer, "fused_ln_ffn_residual",
                        lambda *a, **k: pytest.fail("K3 ran under int8"))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 20, 16)).astype(np.float32))
    with torch.no_grad():
        got = model(x, mask=torch.ones((1, 20), dtype=torch.bool), sig=True)
        unfused = build_midi_extractor(dict(config, fuse_ffn=False)).eval()
        load_jax_variables(unfused, variables["params"], variables["batch_stats"])
        quant.quantize_params(unfused)
        want = unfused(x, mask=torch.ones((1, 20), dtype=torch.bool), sig=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_training_never_quantizes():
    """A task built from a config that carries the serving key trains the
    f32 model (int8 has no gradient)."""
    from some_tpu_torch.training.me_task import MIDIExtractionTask
    from tests.test_training import TINY_CONFIG

    task = MIDIExtractionTask(dict(TINY_CONFIG, quantize="int8"), device="cpu")
    model = task.init_state().model
    assert model.quant == "none"
    assert all(t.dtype == torch.float32 for t in model.state_dict().values())


# ---- the engine ----

@pytest.fixture(scope="module")
def engine_variables():
    from some_tpu.nn.model import build_midi_extractor as jax_build

    v = _np(jax_build(CONFIG).init(jax.random.PRNGKey(0), np.zeros((1, 32, 80), np.float32)))
    return {"params": v["params"], "batch_stats": _stats(v["batch_stats"], 2)}


def _events(outs):
    """Note dicts of consecutive chunks -> one (onsets, offsets, pitches) of
    their voiced notes, each chunk 10 s after the one before."""
    on, off, pitch = [], [], []
    for i, out in enumerate(outs):
        keep = ~out["note_rest"]
        start = 10.0 * i + np.concatenate([[0.0], np.cumsum(out["note_dur"])[:-1]])
        on.append(start[keep])
        off.append((start + out["note_dur"])[keep])
        pitch.append(out["note_midi"][keep])
    return tuple(np.concatenate(a) for a in (on, off, pitch))


def _f1(got, want):
    return note_f1(_events(want), _events(got), onset_tolerance=0.05, pitch_tolerance=0.5).f1


def test_int8_engine_matches_jax_engine(engine_variables):
    """The same chunks in the same buckets (padding rows and all, which the
    activation amax covers) through both int8 engines, f32, the port
    quantizing the f32 weights itself: note F1 >= 0.95 over all chunks.

    Not 0.99: at this width, with random weights, the notes sit on knife
    edges, and int8 moves them wherever an activation lands on a .5 code
    boundary, so two frameworks whose f32 values differ by an ulp (the
    unquantized engines give the same notes) round some codes apart. The
    JAX engine shows the same spread against itself: nudging its input
    projections by one ulp moves its int8 notes (F1 0.98 on these chunks)
    and leaves its f32 notes as they were; the test holds that too.

    Then the JAX engine's quantized variables carried across: the port
    does not quantize them again, and its notes equal its own int8
    engine's bit for bit."""
    config = dict(CONFIG, quantize="int8")
    jax_engine = JaxEngine.from_variables(dict(config), engine_variables, dtype=jnp.float32)
    port = MIDIExtractionInference.from_state_dict(
        dict(config), jax_params_to_state_dict(engine_variables["params"],
                                               engine_variables["batch_stats"]),
        dtype=torch.float32, device="cpu")
    assert port.model.quant == "int8"
    assert any(t.dtype == torch.int8 for t in port.model.state_dict().values())
    # five chunks of bucket 512 (a sixth row pads the group) and a short one
    chunks = [make_song(1000 + i) for i in range(5)] + [make_song(1005)[:2 * 44100]]
    want = jax_engine.infer(chunks)
    got = port.infer(chunks)
    f1 = _f1(got, want)
    nudged = jax.tree_util.tree_map(lambda a: a, engine_variables)
    for name in ("in_proj_midi", "in_proj_bound"):
        kernel = engine_variables["params"]["backbone"][name]["kernel"]
        nudged["params"]["backbone"][name] = dict(
            nudged["params"]["backbone"][name],
            kernel=np.nextafter(kernel, np.float32(np.inf)).astype(np.float32))
    jax_nudged = JaxEngine.from_variables(dict(config), nudged, dtype=jnp.float32).infer(chunks)
    f1_jax_nudged = _f1(jax_nudged, want)
    f32_nudged = _f1(JaxEngine.from_variables(dict(CONFIG), nudged, dtype=jnp.float32)
                     .infer(chunks),
                     JaxEngine.from_variables(dict(CONFIG), engine_variables, dtype=jnp.float32)
                     .infer(chunks))
    print(f"int8 engine vs JAX int8 engine, f32: note F1 {f1:.4f}; JAX int8 against itself "
          f"with its input projections one ulp off {f1_jax_nudged:.4f} (f32 {f32_nudged:.4f})")
    assert sum(len(w["note_dur"]) for w in want) > 0
    assert f1 >= 0.95
    assert f1_jax_nudged < 1.0 and f32_nudged == 1.0

    qvars = jax_engine.variables
    carried = jax_params_to_state_dict(_np(qvars["params"]), _np(qvars["batch_stats"]),
                                       _np(qvars["qscales"]))
    again = MIDIExtractionInference.from_state_dict(dict(config), carried,
                                                    dtype=torch.float32, device="cpu")
    sd = port.model.state_dict()
    assert all(torch.equal(t, sd[k]) for k, t in again.model.state_dict().items())
    for g, w in zip(again.infer(chunks), got):
        for key in ("note_midi", "note_dur", "note_rest"):
            np.testing.assert_array_equal(g[key], w[key])
    with pytest.raises(ValueError, match="quantize: int8"):
        MIDIExtractionInference.from_state_dict(dict(CONFIG), carried, device="cpu")


def test_int8_weight_bytes(engine_variables):
    """Resident weights: the int8 engine holds the quantized products'
    weights in a quarter of the f32 bytes (plus one f32 scale a channel)."""
    state = jax_params_to_state_dict(engine_variables["params"], engine_variables["batch_stats"])
    f32 = MIDIExtractionInference.from_state_dict(dict(CONFIG), state, device="cpu")
    q8 = MIDIExtractionInference.from_state_dict(dict(CONFIG, quantize="int8"), state,
                                                 device="cpu")
    quantized = dict(quant.quantizable_modules(f32.model))
    w_bytes = sum(m.weight.numel() for m in quantized.values())
    scale_bytes = 4 * sum(m.weight.shape[0] for m in quantized.values())
    assert f32.weight_bytes == sum(t.numel() * 4 for t in state.values())
    assert q8.weight_bytes == f32.weight_bytes - 3 * w_bytes + scale_bytes
    print(f"weight bytes f32 {f32.weight_bytes}, int8 {q8.weight_bytes} "
          f"({f32.weight_bytes / q8.weight_bytes:.2f}x)")
