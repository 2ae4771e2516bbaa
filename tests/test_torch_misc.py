"""The port's ``utils/misc.py`` against the JAX package's
``some_tpu/utils/misc.py`` on seeded inputs."""
import jax
import numpy as np
import pytest
import torch

from some_tpu.nn.model import build_midi_extractor as jax_build
from some_tpu.utils import misc as jax_misc
from some_tpu_torch.compat.from_jax import jax_params_to_state_dict
from some_tpu_torch.nn.model import build_midi_extractor
from some_tpu_torch.utils import misc
from tests.test_inference import TINY_MODEL_CONFIG


def test_num_params_and_print_arch(capsys):
    """num_params on the port's state dict of the JAX params, and on the
    port's module, against JAX's count of the same variables; the lines
    both print."""
    v = jax_build(TINY_MODEL_CONFIG).init(jax.random.PRNGKey(4), np.zeros((1, 32, 80),
                                                                           np.float32))
    want = jax_misc.num_params(v["params"], model_name="jax")
    jax_line = capsys.readouterr().out
    state = jax_params_to_state_dict(v["params"])
    assert misc.num_params(state, model_name="jax") == want
    assert capsys.readouterr().out == jax_line
    model = build_midi_extractor(TINY_MODEL_CONFIG)
    assert misc.num_params(model, print_out=False) == want
    assert misc.num_params({"a": [torch.zeros(3, 4)], "b": torch.zeros(2)},
                           print_out=False) == 14 / 1e6
    misc.print_arch(model, model_name="port")
    out = capsys.readouterr().out
    assert out.startswith("| port Arch: ") and out.endswith(
        f"| port Trainable Parameters: {want:.3f}M\n")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tensors_to_scalars_and_remove_padding(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 3, size=(12, 4)).astype(np.float32)
    x[rng.random(12) < 0.4] = 0
    v = rng.integers(0, 3, size=17)
    for got, want in ((misc.remove_padding(x), jax_misc.remove_padding(x)),
                      (misc.remove_padding(torch.from_numpy(x)).numpy(),
                       jax_misc.remove_padding(x)),
                      (misc.remove_padding(v), jax_misc.remove_padding(v))):
        np.testing.assert_array_equal(got, want)
    assert misc.remove_padding(None) is None
    with pytest.raises(ValueError, match="1-D or 2-D"):
        misc.remove_padding(np.zeros((2, 2, 2)))
    metrics = {"loss": torch.tensor(float(x.sum())), "n": np.int64(v.sum()),
               "nested": {"acc": np.float32(x.mean()), "vec": x[0]}, "name": "a"}
    got = misc.tensors_to_scalars(metrics)
    want = jax_misc.tensors_to_scalars({**metrics, "loss": np.float32(x.sum())})
    assert got["loss"] == want["loss"] and got["n"] == want["n"] and got["name"] == "a"
    assert got["nested"]["acc"] == want["nested"]["acc"]
    assert isinstance(got["loss"], float) and isinstance(got["n"], int)
    np.testing.assert_array_equal(got["nested"]["vec"], x[0])


@pytest.mark.parametrize("shape, dim", [((4, 9), 1), ((3, 10, 2), 1), ((7,), 0)])
def test_random_continuous_masks(shape, dim):
    """The same spans as the JAX helper from one numpy generator's seed."""
    got = misc.random_continuous_masks(*shape, dim=dim, rng=np.random.default_rng(7))
    want = jax_misc.random_continuous_masks(*shape, dim=dim, rng=np.random.default_rng(7))
    np.testing.assert_array_equal(got, want)
    # the axes after dim are 1: the masks broadcast over them
    assert got.shape == shape[:dim + 1] + (1,) * (len(shape) - dim - 1) and got.dtype == bool
    # each span is contiguous along dim
    starts = np.diff(got.astype(np.int8), axis=dim, prepend=0) == 1
    assert (starts.sum(axis=dim) <= 1).all()
