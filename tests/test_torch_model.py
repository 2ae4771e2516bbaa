"""Model of the PyTorch port against the JAX package.

Weights come from ``MidiExtractor.init`` (with randomized BatchNorm
statistics) and are carried across by ``jax_params_to_state_dict``; the same
numpy inputs go through both models.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from some_tpu.nn.conformer import ConformerBlock as JaxBlock
from some_tpu.nn.model import MidiExtractor as JaxModel
from some_tpu_torch.compat.from_jax import (
    jax_params_to_state_dict, jax_variable_shapes, load_jax_variables, random_jax_variables,
)
from some_tpu_torch.nn.conformer import ConformerBlock
from some_tpu_torch.nn.model import MidiExtractor, build_midi_extractor

LAY, DIM, INDIM, OUTDIM, HEADS, HEAD_DIM, KS = 2, 64, 16, 32, 2, 32, 7
GEOMETRY = dict(lay=LAY, dim=DIM, indim=INDIM, outdim=OUTDIM, kernel_size=KS,
                attention_heads=HEADS, attention_heads_dim=HEAD_DIM)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_variables():
    rng = np.random.default_rng(5)
    x = np.zeros((1, 8, INDIM), np.float32)
    v = _numpy_tree(JaxModel(**GEOMETRY).init(jax.random.PRNGKey(0), x))
    stats = jax.tree_util.tree_map(
        lambda a: (rng.normal(0, 0.5, a.shape) if a.ndim and a.sum() == 0
                   else rng.uniform(0.5, 2.0, a.shape)).astype(np.float32),
        v["batch_stats"])
    return {"params": v["params"], "batch_stats": stats}


def _torch_model(variables, dtype=torch.float32):
    model = MidiExtractor(**GEOMETRY, dtype=dtype).eval()
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    return model


def test_every_leaf_maps_and_every_parameter_fills(jax_variables):
    model = MidiExtractor(**GEOMETRY)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jax_variables)
    assert jax_variable_shapes(model) == shapes
    load_jax_variables(model, jax_variables["params"], jax_variables["batch_stats"])
    state = jax_params_to_state_dict(jax_variables["params"], jax_variables["batch_stats"])
    assert set(state) == set(model.state_dict())
    q = jax_variables["params"]["backbone"]["layer_0"]["midi_block"]["attn"]["q_proj"]["kernel"]
    np.testing.assert_array_equal(
        state["backbone.layer_0.midi_block.attn.q_proj.weight"].numpy(), q.T)
    dw = jax_variables["params"]["backbone"]["final_bound"]["conv"]["dw"]["kernel"]
    np.testing.assert_array_equal(
        state["backbone.final_bound.conv.dw.weight"].numpy(), dw)  # [k, C] kept

    extra = {"params": {**jax_variables["params"], "stray": {"thing": np.zeros(3)}}}
    with pytest.raises(KeyError, match="unmapped"):
        jax_params_to_state_dict(extra["params"])
    extra_dense = {**jax_variables["params"], "extra": {"kernel": np.zeros((2, 2))}}
    with pytest.raises(KeyError, match="unmapped"):
        load_jax_variables(model, extra_dense, jax_variables["batch_stats"])
    with pytest.raises(KeyError, match="unfilled"):
        load_jax_variables(model, jax_variables["params"], {})


def test_random_variables_have_the_flax_layout():
    config = {"units_dim": INDIM, "midi_num_bins": OUTDIM,
              "midi_extractor_args": {**{k: v for k, v in GEOMETRY.items()
                                         if k not in ("indim", "outdim")},
                                      "use_lay_skip": True, "conv_drop": 0.1}}
    model = build_midi_extractor(config)
    init = JaxModel(**GEOMETRY).init(jax.random.PRNGKey(1), np.zeros((1, 8, INDIM), np.float32))
    drawn = random_jax_variables(model, seed=3)
    assert (jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), drawn)
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), _numpy_tree(init)))
    again = random_jax_variables(model, seed=3)
    jax.tree_util.tree_map(np.testing.assert_array_equal, drawn, again)


def test_single_block_parity_tight():
    """One conformer block to 5e-5, as tests/test_model.py holds JAX to torch."""
    rng = np.random.default_rng(3)
    block = JaxBlock(dim=DIM, kernel_size=KS, heads=HEADS, head_dim=HEAD_DIM, dtype=jnp.float32)
    x = rng.standard_normal((2, 19, DIM)).astype(np.float32)
    mask = np.ones((2, 19), bool)
    mask[1, 13:] = False
    v = _numpy_tree(block.init(jax.random.PRNGKey(2), x, mask=mask))
    stats = {"conv": {"bn": {"mean": rng.normal(0, 0.5, DIM).astype(np.float32),
                             "var": rng.uniform(0.5, 2.0, DIM).astype(np.float32)}}}
    params = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, 0.1, a.shape)).astype(np.float32), v["params"])
    want = np.asarray(block.apply({"params": params, "batch_stats": stats}, x, mask=mask))
    ours = ConformerBlock(DIM, KS, HEADS, HEAD_DIM, torch.float32).eval()
    load_jax_variables(ours, params, stats)
    with torch.no_grad():
        got = ours(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    print(f"parity conformer block f32: max|d| {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3), ("bfloat16", 5e-2)])
@pytest.mark.parametrize("sig,softmax", [(True, False), (False, True), (False, False)])
def test_full_model_matches_jax(jax_variables, dtype, tol, sig, softmax):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 33, INDIM)).astype(np.float32)
    mask = np.ones((3, 33), bool)
    mask[1, 21:] = False
    mask[2] = False  # a batch-padding row
    jm = JaxModel(**GEOMETRY, dtype=getattr(jnp, dtype))
    want = jm.apply(jax_variables, x, mask=mask, sig=sig, softmax=softmax)
    model = _torch_model(jax_variables, getattr(torch, dtype))
    with torch.no_grad():
        got = model(torch.from_numpy(x), mask=torch.from_numpy(mask), sig=sig, softmax=softmax)
    for g, w in zip(got, want):
        g = g.float().numpy()
        assert np.isfinite(g).all()
        print(f"parity model {dtype} sig={sig} softmax={softmax}: "
              f"max|d| {np.abs(g - np.asarray(w, np.float32)).max():.3g}")
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=tol, rtol=tol)


def test_padded_bucket_equivalence(jax_variables):
    """Padding to a bucket with masking reproduces the unpadded output."""
    model = _torch_model(jax_variables)
    rng = np.random.default_rng(13)
    T, T_pad = 29, 48
    x = torch.from_numpy(rng.standard_normal((1, T, INDIM)).astype(np.float32))
    x_pad = torch.zeros((1, T_pad, INDIM))
    x_pad[:, :T] = x
    mask_pad = torch.zeros((1, T_pad), dtype=torch.bool)
    mask_pad[:, :T] = True
    with torch.no_grad():
        midi, bound = model(x, mask=torch.ones((1, T), dtype=torch.bool), sig=True)
        midi_pad, bound_pad = model(x_pad, mask=mask_pad, sig=True)
    torch.testing.assert_close(midi_pad[:, :T], midi, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(bound_pad[:, :T], bound, atol=1e-5, rtol=1e-5)


def test_unported_options_raise():
    config = {"units_dim": INDIM, "midi_num_bins": OUTDIM,
              "midi_extractor_args": {k: v for k, v in GEOMETRY.items()
                                      if k not in ("indim", "outdim")}}
    with pytest.raises(NotImplementedError, match="K3"):
        build_midi_extractor(dict(config, fuse_ffn=True))
    with pytest.raises(NotImplementedError, match="int8"):
        build_midi_extractor(dict(config, quantize="int8"))
