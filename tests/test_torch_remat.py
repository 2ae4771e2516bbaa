"""Every ``remat_policy`` of the port against ``nothing`` and the JAX package.

Small geometry (tests/test_training.py's TINY_CONFIG: 1 layer, dim 32,
2 x 16 heads, k 7; and tests/test_torch_train.py's parity geometry), on the
CPU, f32. A policy decides what the forward keeps for the backward, never
the arithmetic, so:
  * with dropout 0.1 and BatchNorm training, each policy's loss, every
    gradient and the BatchNorm running statistics equal ``nothing``'s bit for
    bit, and the running statistics equal a run without remat (one update
    a step, not a second one in the recompute); the gradients equal the
    run without remat's too, so the recompute drew the same dropout masks;
  * the ops the recompute runs again are the ones the policy does not keep
    (counted with a dispatch mode around the backward): ``dots`` runs no
    product again, ``dots_no_batch`` the plain attention's batched products
    only, ``save_attn_conv`` no marked tensor;
  * one train step equals the JAX train step under the same ``remat_policy``
    (dropout 0, tests/test_torch_train.py's tolerances: losses rel 1e-3,
    grad_norm rel 2e-3, then the state);
  * what the JAX package's lowering runs again, counted in the jaxpr of
    its gradient (exp for the attention's softmax, conv_general_dilated for
    the depthwise conv on the CPU) against the port's backward: the
    attention runs again in each remat'd block under every policy in both;
    JAX keeps the conv's output only under ``dots`` (its ``checkpoint_dots``
    saves convolutions, and on the CPU the conv is one), where on the TPU
    the Pallas kernel, as the port's K1 on the card, runs again.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from some_tpu.parallel.mesh import shard_batch
from some_tpu_torch.compat.from_jax import jax_params_to_state_dict
from some_tpu_torch.nn.conformer import REMAT_POLICIES, set_dropout_step
from some_tpu_torch.training.me_task import MIDIExtractionTask
from tests.test_torch_train import (
    _config, _jax_task, _np, _ragged_batches, assert_state_matches,
)
from tests.test_training import TINY_CONFIG, make_item


class _OpCounter(TorchDispatchMode):
    """Counts the aten ops that run (not those a selective checkpoint serves
    from its cache)."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket).split(".")[-1]
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _grads(policy, remat=True, start=None):
    """loss, {name: grad}, running statistics and the backward's op counts
    of one forward and backward of TINY_CONFIG (dropout 0.1) on 3 rows."""
    config = dict(TINY_CONFIG, use_remat=remat, remat_policy=policy)
    task = MIDIExtractionTask(config, device="cpu")
    state = task.init_state()
    if start is not None:
        state.model.load_state_dict(start)
    model = state.model
    model.train()
    set_dropout_step(model, config["seed"], 3)
    batch = task.to_device(task.collate([make_item(np.random.default_rng(i), 50 - 7 * i, 4)
                                         for i in range(3)]))
    total = sum(task.compute_losses(model(**task.model_inputs(batch)), batch).values())
    with _OpCounter() as counter:
        total.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
    return float(total.detach()), grads, stats, counter.counts


@pytest.fixture(scope="module")
def reference():
    """``nothing``'s and no-remat's results from one start."""
    start = {k: v.clone() for k, v in MIDIExtractionTask(dict(TINY_CONFIG), device="cpu")
             .init_state().model.state_dict().items()}
    return start, _grads("nothing", start=start), _grads("nothing", remat=False, start=start)


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_policy_equals_nothing_bit_for_bit(policy, reference):
    start, (loss0, grads0, stats0, counts0), (loss_nr, grads_nr, stats_nr, counts_nr) = reference
    loss, grads, stats, counts = _grads(policy, start=start)
    assert loss == loss0 == loss_nr
    for name, g in grads.items():
        assert torch.equal(g, grads0[name]), name
        assert torch.equal(g, grads_nr[name]), name
    for name, s in stats.items():
        assert torch.equal(s, stats0[name]) and torch.equal(s, stats_nr[name]), name
    # what the backward ran again: the products the policy keeps are not
    mm, bmm = counts.get("mm", 0), counts.get("bmm", 0)
    if policy == "nothing":
        assert counts == counts0
    elif policy == "dots":
        assert mm < counts0["mm"] and bmm < counts0["bmm"]
    elif policy == "dots_no_batch":
        assert mm < counts0["mm"] and bmm == counts0["bmm"]
    else:  # save_attn_conv: every product runs again, the marked tensors do not
        assert mm == counts0["mm"] and bmm == counts0["bmm"]
        assert "checkpoint_name" not in counts
    if policy in ("dots", "dots_no_batch"):
        # the kept products are exactly those nothing's recompute runs (its
        # backward's less a backward without remat's), so the backward runs
        # only its own
        assert mm == counts_nr["mm"]


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="remat_policy 'everything'"):
        MIDIExtractionTask(dict(TINY_CONFIG, remat_policy="everything"),
                           device="cpu").init_state()


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_train_step_matches_jax_under_policy(policy):
    """One step of a ragged batch with a padding row, dropout 0, from the JAX
    task's initial weights under the same policy."""
    config = dict(_config(remat=True), remat_policy=policy)
    jtask, mesh, jstep, jstate = _jax_task(config)
    task = MIDIExtractionTask(config, device="cpu")
    state = task.init_state()
    state.model.load_state_dict(jax_params_to_state_dict(_np(jstate.params),
                                                         _np(jstate.batch_stats)))
    batch = _ragged_batches(task, 1, seed=37)[0]
    jstate, jlogs = jstep(jstate, shard_batch(batch, mesh))
    logs = task.train_step(state, batch)
    for key in ("midi_loss", "bound_loss", "total_loss"):
        assert float(logs[key]) == pytest.approx(float(jlogs[key]), rel=1e-3, abs=1e-6), key
    assert float(logs["grad_norm"]) == pytest.approx(float(jlogs["grad_norm"]), rel=2e-3)
    assert_state_matches(state.model, jstate)


def _jaxpr_counts(jaxpr, acc):
    for eqn in jaxpr.eqns:
        acc[eqn.primitive.name] = acc.get(eqn.primitive.name, 0) + 1
        for value in eqn.params.values():
            for sub in (value if isinstance(value, (list, tuple)) else [value]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    _jaxpr_counts(inner, acc)
    return acc


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_recompute_matches_jax_lowering(policy, reference):
    """TINY_CONFIG: 1 remat'd layer (2 blocks) and 2 final blocks."""
    import jax

    from some_tpu.nn.conformer import MidiConformer

    args = TINY_CONFIG["midi_extractor_args"]
    jmodel = MidiConformer(lay=1, dim=args["dim"], indim=16, outdim=8,
                           kernel_size=args["kernel_size"], attention_heads=args["attention_heads"],
                           attention_heads_dim=args["attention_heads_dim"], remat=True,
                           remat_policy=policy, attn_impl="xla")
    x = np.random.default_rng(0).standard_normal((2, 32, 16)).astype(np.float32)
    mask = np.ones((2, 32), bool)
    variables = jmodel.init(jax.random.PRNGKey(0), x, mask=mask)

    def loss(params):
        (a, b), _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                 x, mask=mask, deterministic=False, use_running_average=False,
                                 mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(1)})
        return a.sum() + b.sum()

    fwd = _jaxpr_counts(jax.make_jaxpr(loss)(variables["params"]).jaxpr, {})
    grad = _jaxpr_counts(jax.make_jaxpr(jax.grad(loss))(variables["params"]).jaxpr, {})
    jax_attn_again = grad["exp"] - fwd["exp"]
    jax_conv_again = grad["conv_general_dilated"] - 2 * fwd["conv_general_dilated"]
    assert fwd["exp"] == 4 and jax_attn_again == 2
    assert jax_conv_again == (0 if policy == "dots" else 2)
    counts = _grads(policy, start=reference[0])[3]
    assert counts["_softmax"] == jax_attn_again  # the port's recompute
