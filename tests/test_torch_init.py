"""``torch_style_init: false``: flax's own initializers, against the JAX task.

The JAX task draws with ``jax.random`` (threefry), which the port does not
copy, so the values differ; what is held:
  * the parameter set and every shape equal the JAX ``init_state``'s (1
    layer, dim 32, 2 x 16 heads, k 7: the test geometry of
    tests/test_torch_train.py), with and without remat;
  * where flax gives exact values (every bias 0, LayerNorm and BatchNorm
    scales 1, BatchNorm statistics 0 and 1), the port's are equal;
  * at production width (configs/midi_conformer.yaml: 8 layers, dim 512,
    8 x 64 heads, k 31, 80 -> 128), each kernel's standard deviation lies
    within 5% of flax's lecun_normal, sqrt(1 / fan_in), and no value lies
    beyond its truncation at 2 / 0.8796 x sqrt(1 / fan_in); the JAX draw at
    the small geometry meets the same bounds.
"""
import pathlib

import jax
import numpy as np
import pytest
import torch

from some_tpu.training.me_task import MIDIExtractionTask as JaxTask
from some_tpu_torch.compat.from_jax import jax_params_to_state_dict
from some_tpu_torch.training.me_task import MIDIExtractionTask
from tests.test_torch_train import _config

REPO = pathlib.Path(__file__).resolve().parent.parent
TRUNC = 0.87962566103423978


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _kernel_bounds(key, w):
    """(flax's std, the truncation bound) of a port weight: a Dense
    ``[out, in]`` (fan_in = in) or the depthwise ``[k, C]`` (fan_in = k)."""
    fan_in = w.shape[0] if key.endswith("dw.weight") else w.shape[1]
    std = np.sqrt(1.0 / fan_in)
    return std, 2.0 * std / TRUNC


def _is_kernel(key, w):
    return key.endswith(".weight") and w.dim() == 2


@pytest.mark.parametrize("remat", [True, False])
def test_flax_init_has_jax_parameter_set_and_exact_values(remat):
    config = dict(_config(remat=remat), torch_style_init=False)
    jstate = JaxTask(config).init_state()
    want = jax_params_to_state_dict(_np(jstate.params), _np(jstate.batch_stats))
    got = MIDIExtractionTask(config, device="cpu").init_state().model.state_dict()
    assert set(got) == set(want)
    n_exact = 0
    for key, ref in want.items():
        assert got[key].shape == ref.shape, key
        if _is_kernel(key, ref):
            assert not torch.equal(got[key], ref), key  # other draws than threefry's
            std, limit = _kernel_bounds(key, ref)
            assert float(ref.abs().max()) <= limit * (1 + 1e-6), key  # JAX's own draw
            assert float(got[key].abs().max()) <= limit * (1 + 1e-6), key
        else:  # biases, norm scales, BatchNorm statistics: flax's constants
            assert torch.equal(got[key], ref), key
            n_exact += 1
    assert n_exact > 50


def test_flax_init_std_at_production_width():
    from some_tpu_torch.config import read_full_config

    config = read_full_config(REPO / "configs" / "midi_conformer.yaml")
    config.update(torch_style_init=False, pl_trainer_precision="32-true")
    model = MIDIExtractionTask(config, device="cpu").init_state().model
    seen = 0
    for key, w in model.state_dict().items():
        if not _is_kernel(key, w):
            continue
        std, limit = _kernel_bounds(key, w)
        got = float(w.double().std())
        assert abs(got / std - 1.0) <= 0.05, (key, tuple(w.shape), got, std)
        assert float(w.abs().max()) <= limit * (1 + 1e-6), key
        seen += 1
    assert seen == 2 + 18 * 10 + 16 + 2  # in-projections, 10 a block, gates, heads
    # a second seed gives other weights, the same seed the same ones
    again = MIDIExtractionTask(config, device="cpu").init_state().model.state_dict()
    key = "backbone.layer_0.midi_block.conv.dw.weight"
    assert torch.equal(again[key], model.state_dict()[key])
    other = MIDIExtractionTask(config, device="cpu").init_state(seed=1).model.state_dict()
    assert not torch.equal(other[key], again[key])
