"""Finetuning (``finetune_enabled``) against the JAX trainer, on the CPU.

The geometry of tests/test_training.py (TINY_CONFIG: 1 layer, dim 32,
2 x 16 heads, k 7, f32). It mirrors
tests/test_training.py::test_finetune_partial_load: the JAX trainer and the
port's restore the same donor checkpoint into a fresh run, and every leaf
(weights and BatchNorm statistics) is equal bit for bit, ignored leaves at
their fresh values (the port's initial weights equal the JAX task's). The
prefixes of ``finetune_ignored_params`` are matched with and without
``model.`` and with the flax collection; ``finetune_strict_shapes`` raises
on a leaf of another shape, and without it that leaf keeps its fresh value.
A reference Lightning file (tests/torch_oracle.py) finetunes the same way.
"""
import jax
import numpy as np
import pytest
import torch

from some_tpu.parallel.mesh import make_mesh
from some_tpu.training.checkpoint import save_checkpoint as jax_save
from some_tpu.training.me_task import MIDIExtractionTask as JaxTask
from some_tpu.training.trainer import Trainer as JaxTrainer
from some_tpu_torch.compat.from_jax import jax_params_to_state_dict
from some_tpu_torch.training.me_task import MIDIExtractionTask
from some_tpu_torch.training.trainer import Trainer
from tests.test_training import TINY_CONFIG, make_item


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def donor(tmp_path_factory):
    """A JAX checkpoint of distinctive values: the seed-99 init + 0.5, and
    BatchNorm statistics that are not the initial ones."""
    d = tmp_path_factory.mktemp("donor")
    state = JaxTask(dict(TINY_CONFIG)).init_state(seed=99)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.5, _np(state.params))
    stats = jax.tree_util.tree_map(lambda x: np.asarray(x) * 0.5 + 0.25, _np(state.batch_stats))
    jax_save(d, 1234, params, stats)
    return d / "model_ckpt_steps_1234.ckpt", params, stats


def _both(config, tmp_path, tag):
    """(JAX state as a port state_dict, the port's state) after restore_or_init."""
    jstate = JaxTrainer(JaxTask(dict(config)), tmp_path / f"jax-{tag}",
                        mesh=make_mesh(jax.devices()[:1])).restore_or_init()
    want = jax_params_to_state_dict(_np(jstate.params), _np(jstate.batch_stats))
    state = Trainer(MIDIExtractionTask(dict(config), device="cpu"),
                    tmp_path / f"port-{tag}").restore_or_init()
    assert int(jstate.step) == state.step == 0  # a finetune start, not a resume
    return want, state


@pytest.mark.parametrize("ignored", ["model.backbone.bound_head", "backbone.bound_head",
                                     "params.backbone.bound_head",
                                     "model.backbone.layer_0.midi_block.conv.bn"])
def test_finetune_matches_jax_leaf_for_leaf(donor, tmp_path, ignored):
    path, params, stats = donor
    config = dict(TINY_CONFIG, finetune_enabled=True, finetune_ckpt_path=str(path),
                  finetune_ignored_params=[ignored], finetune_strict_shapes=True)
    want, state = _both(config, tmp_path, "ft")
    got = state.model.state_dict()
    file_sd = jax_params_to_state_dict(params, stats)
    fresh = MIDIExtractionTask(dict(TINY_CONFIG), device="cpu").init_state().model.state_dict()
    prefix = ignored.split(".", 1)[1] if ignored.split(".")[0] in ("model", "params") else ignored
    n_ignored = 0
    for key, ref in want.items():
        assert torch.equal(got[key], ref), key
        if key.startswith(prefix):  # weights and BatchNorm statistics both follow it
            assert torch.equal(got[key], fresh[key]) and not torch.equal(got[key], file_sd[key])
            n_ignored += 1
        else:
            assert torch.equal(got[key], file_sd[key]), key
    assert n_ignored == (4 if "conv.bn" in ignored else 2)
    # the optimizer starts fresh
    assert not state.optimizer.state


def test_finetune_shapes_strict_and_lax(donor, tmp_path, caplog):
    path, params, stats = donor
    bad = jax.tree_util.tree_map(np.asarray, params)
    bad["backbone"]["out_proj"]["kernel"] = np.zeros((7, 7), np.float32)
    jax_save(tmp_path / "bad", 1, bad, stats)
    config = dict(TINY_CONFIG, finetune_enabled=True,
                  finetune_ckpt_path=str(tmp_path / "bad" / "model_ckpt_steps_1.ckpt"),
                  finetune_ignored_params=[], finetune_strict_shapes=True)
    with pytest.raises(ValueError, match="shape mismatch for params.backbone.out_proj.kernel"):
        Trainer(MIDIExtractionTask(dict(config), device="cpu"),
                tmp_path / "strict").restore_or_init()
    lax = dict(config, finetune_strict_shapes=False)
    with caplog.at_level("WARNING"):
        want, state = _both(lax, tmp_path, "lax")
    assert "unmatched key (shape): params.backbone.out_proj.kernel" in caplog.text
    got = state.model.state_dict()
    fresh = MIDIExtractionTask(dict(TINY_CONFIG), device="cpu").init_state().model.state_dict()
    for key, ref in want.items():
        assert torch.equal(got[key], ref), key
    assert torch.equal(got["backbone.out_proj.weight"], fresh["backbone.out_proj.weight"])


def test_resume_wins_over_finetune(donor, tmp_path):
    """A work directory with a checkpoint resumes from it; the finetune file
    is read only for a fresh run."""
    path, _, _ = donor
    config = dict(TINY_CONFIG, finetune_enabled=True, finetune_ckpt_path=str(path))
    task = MIDIExtractionTask(dict(config), device="cpu")
    trainer = Trainer(task, tmp_path / "w")
    state = trainer.restore_or_init()
    state.step = 6
    trainer._save_ckpt(6, state, 0, 6)
    resumed = Trainer(MIDIExtractionTask(dict(config, finetune_ckpt_path=str(tmp_path / "none")),
                                         device="cpu"), tmp_path / "w").restore_or_init()
    assert resumed.step == 6
    for key, value in state.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[key], value), key


class AttributeDict(dict):
    """Lightning's hyper-parameter dict: a pickled class that
    ``torch.load(weights_only=True)`` refuses."""


def test_finetune_from_lightning_file_and_frozen(tmp_path):
    """A reference Lightning ``.ckpt`` (OracleModel, random BatchNorm
    statistics) finetunes into the port as into the JAX trainer, leaf for
    leaf; with ``in_proj_midi`` frozen, two steps leave it at the file's
    value bit for bit while the rest trains."""
    from some_tpu_torch.compat.torch_ckpt import reference_state_dict
    from tests.torch_oracle import OracleModel

    args = TINY_CONFIG["midi_extractor_args"]
    torch.manual_seed(5)
    oracle = OracleModel(args["lay"], args["dim"], TINY_CONFIG["units_dim"],
                         TINY_CONFIG["midi_num_bins"], kernel_size=args["kernel_size"],
                         heads=args["attention_heads"], dim_head=args["attention_heads_dim"])
    with torch.no_grad():
        for m in oracle.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    payload = {"state_dict": {f"model.{k}": v for k, v in oracle.state_dict().items()},
               "hyper_parameters": AttributeDict(TINY_CONFIG), "global_step": 0}
    torch.save(payload, tmp_path / "model.ckpt")
    config = dict(TINY_CONFIG, finetune_enabled=True,
                  finetune_ckpt_path=str(tmp_path / "model.ckpt"),
                  finetune_ignored_params=["model.backbone.bound_head"])
    want, state = _both(config, tmp_path, "lightning")
    got = state.model.state_dict()
    file_sd = reference_state_dict(payload)
    for key, ref in want.items():
        assert torch.equal(got[key], ref), key
        if not key.startswith("backbone.bound_head"):
            assert torch.equal(got[key], file_sd[key]), key

    frozen = dict(config, freezing_enabled=True, frozen_params=["model.backbone.in_proj_midi"])
    task = MIDIExtractionTask(frozen, device="cpu")
    state = Trainer(task, tmp_path / "frozen").restore_or_init()
    batch = task.collate([make_item(np.random.default_rng(2), 48, 4)])
    for _ in range(2):
        task.train_step(state, batch)
    sd = state.model.state_dict()
    assert torch.equal(sd["backbone.in_proj_midi.weight"], file_sd["backbone.in_proj_midi.weight"])
    assert torch.equal(sd["backbone.in_proj_midi.bias"], file_sd["backbone.in_proj_midi.bias"])
    assert not torch.equal(sd["backbone.in_proj_bound.weight"],
                           file_sd["backbone.in_proj_bound.weight"])
