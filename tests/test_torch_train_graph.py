"""The port's compiled train and valid steps, on the CPU, against the JAX
package's jitted ``make_train_step`` / ``make_valid_step``.

On the card a train step is one CUDA graph per batch bucket and
accumulation position (``training/base_task.py``); the CPU runs every step
eagerly. Here the graph cache's plumbing runs with a stand-in for the CUDA
graph: its capture runs the captured body once and puts every tensor the
step updates back as it was (a capture runs nothing), and its replay runs
the body again and writes the results into the capture's outputs in place,
as a replay writes its static outputs. Geometry and tolerances as
tests/test_torch_train.py (1 layer, dim 32; losses rtol 1e-3, grad norm
rtol 2e-3, ``assert_state_matches``); the stand-in dispatch equals the
eager one bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from some_tpu.parallel.mesh import shard_batch
from some_tpu.training.me_task import MIDIExtractionTask as JaxTask
from some_tpu_torch.compat.from_jax import jax_params_to_state_dict
from some_tpu_torch.nn.conformer import Dropout
from some_tpu_torch.training import base_task, optimizers
from some_tpu_torch.training.base_task import set_train_dispatch
from some_tpu_torch.training.me_task import MIDIExtractionTask
from tests.test_torch_train import (
    _config, _jax_task, _np, _ragged_batches, assert_state_matches,
)
from tests.test_train_parity import make_items
from tests.test_training import TINY_CONFIG, make_item


class StandInGraph:
    """A captured step's graph on the CPU: ``replay`` runs the body again
    and writes its outputs into the capture's in place."""

    def __init__(self, run, out):
        self.run, self.out, self.replays = run, out, 0

    def replay(self):
        for static, fresh in zip(tree_leaves(self.out), tree_leaves(self.run())):
            static.copy_(fresh)
        self.replays += 1


def stand_in(task):
    """Switch ``task`` to the graph dispatch with :class:`StandInGraph`s;
    returns the list of its captures (pool, generators registered)."""
    captures = []

    def capture(state, pool, run, generators):
        before = [t.detach().clone() for t in state.static_tensors()]
        out = run()
        after = state.static_tensors()
        # the bucket's first, eager, visit made every tensor the body updates
        assert len(after) == len(before)
        with torch.no_grad():
            for t, saved in zip(after, before):
                t.copy_(saved)
        captures.append((pool, len(generators)))
        return StandInGraph(run, out), out

    task._dispatch = "graph"
    task._capture_graph = capture
    return captures


def _batches_b(task, n, seed):
    """Five rows of up to 70 frames and 10 notes: the (8, 96, 16) bucket."""
    rng = np.random.default_rng(seed)
    return [task.collate(make_items(rng, [70, 52, 33, 20, 61], [10, 7, 5, 3, 9]))
            for _ in range(n)]


def _from_jax(task, jstate):
    state = task.init_state()
    state.model.load_state_dict(jax_params_to_state_dict(_np(jstate.params),
                                                         _np(jstate.batch_stats)))
    return state


def _assert_same(got_logs, want_logs, got_state, want_state):
    for got, want in zip(got_logs, want_logs):
        assert got.keys() == want.keys()
        for key in got:
            assert torch.equal(got[key], want[key]), key
    for (name, a), b in zip(got_state.model.state_dict().items(),
                            want_state.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(got_state.static_tensors(), want_state.static_tensors()):
        assert torch.equal(a, b)


def _shapes(key):
    """{input name: shape} of a graph cache key."""
    return {name: shape for name, shape, _ in key[1]}


def _count_norms(monkeypatch):
    calls = []

    def counted(tensors):
        calls.append(len(tensors))
        return plain(tensors)

    plain = optimizers.global_norm
    monkeypatch.setattr(optimizers, "global_norm", counted)
    monkeypatch.setattr(base_task, "global_norm", counted)
    return calls


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("dispatch", ["eager", "graph"])
def test_step_matches_jax(remat, dispatch, monkeypatch):
    """3 steps on one bucket (eager, capture, replay under the stand-in)
    against the JAX jitted step: the lr a 0-d tensor every param group
    holds, filled from the schedule; one global norm a step, taken once
    for ``grad_norm`` and the clip."""
    jtask, mesh, jstep, jstate = _jax_task(_config(remat=False))
    task = MIDIExtractionTask(_config(remat=remat), device="cpu")
    if dispatch == "graph":
        stand_in(task)
    state = _from_jax(task, jstate)
    norms = _count_norms(monkeypatch)
    seen = []
    for i, batch in enumerate(_ragged_batches(task, 3, seed=13)):
        jstate, jlogs = jstep(jstate, shard_batch(batch, mesh))
        logs = task.train_step(state, batch)
        seen.append(task.last_dispatch)
        assert all(g["lr"] is state.lr for g in state.optimizer.param_groups)
        assert state.lr.dim() == 0 and float(state.lr) == pytest.approx(task.schedule(i))
        for key in ("midi_loss", "bound_loss", "total_loss"):
            assert float(logs[key]) == pytest.approx(float(jlogs[key]), rel=1e-3, abs=1e-6), key
        assert float(logs["grad_norm"]) == pytest.approx(float(jlogs["grad_norm"]), rel=2e-3)
    # the graph dispatch's capture runs the body once more (a CUDA capture
    # traces it without running it)
    assert len(norms) == (4 if dispatch == "graph" else 3)
    assert seen == (["eager", "capture", "replay"] if dispatch == "graph" else ["eager"] * 3)
    assert state.step == int(jstate.step) == 3
    assert_state_matches(state.model, jstate)


@pytest.mark.parametrize("dispatch", ["eager", "graph"])
def test_accumulation_with_frozen_prefix_matches_jax(dispatch):
    """accumulate_grad_batches 2 with ``model.backbone.in_proj_midi`` frozen
    (optax.MultiSteps over multi_transform), over two buckets that take
    turns, so each accumulation group spans both: 8 micro-steps, 4 updates,
    each micro-step's logs against JAX's, the state after 2 updates (as
    tests/test_torch_train.py holds accumulation; the BatchNorm statistics
    drift past its allowance later, as the weights' float noise walks).
    The accumulator (its tensors made once) and AdamW's state are carried
    across the buckets' graphs, and the graph dispatch equals an eager twin
    bit for bit; the frozen weights stay bit for bit."""
    config = dict(_config(remat=True, accum=2), freezing_enabled=True,
                  frozen_params=["model.backbone.in_proj_midi"])
    jtask, mesh, jstep, jstate = _jax_task(dict(config, use_remat=False))
    task = MIDIExtractionTask(config, device="cpu")
    twin = MIDIExtractionTask(config, device="cpu")
    if dispatch == "graph":
        stand_in(task)
    state, twin_state = _from_jax(task, jstate), _from_jax(twin, jstate)
    frozen = state.model.backbone.in_proj_midi.weight.detach().clone()
    a, b = _ragged_batches(task, 4, seed=17), _batches_b(task, 4, seed=19)
    kinds, acc_ptrs, logs, twin_logs = [], set(), [], []
    for i, batch in enumerate(x for pair in zip(a, b) for x in pair):
        jstate, jlogs = jstep(jstate, shard_batch(batch, mesh))
        logs.append(task.train_step(state, batch))
        twin_logs.append(twin.train_step(twin_state, batch))
        kinds.append(task.last_dispatch)
        if state.accumulator is not None:
            assert state.accumulator["grads"] is state.acc_grads
        acc_ptrs.add(tuple(t.data_ptr() for t in state.acc_grads.values()))
        assert float(logs[-1]["total_loss"]) == pytest.approx(float(jlogs["total_loss"]),
                                                              rel=1e-3)
        assert float(logs[-1]["grad_norm"]) == pytest.approx(float(jlogs["grad_norm"]), rel=2e-3)
        if i == 3:
            assert_state_matches(state.model, jstate)
    assert len(acc_ptrs) == 1
    assert state.accumulator is None and state.step == 8
    if dispatch == "graph":
        # (bucket, accumulation position): A at 0 and B at 1, four visits each
        assert kinds == ["eager", "eager", "capture", "capture"] + ["replay"] * 4
        assert len(state.graphs) == 2
        assert sorted(key[0] for key in state.graphs) == [("train", 0), ("train", 1)]
    _assert_same(logs, twin_logs, state, twin_state)
    assert torch.equal(state.model.backbone.in_proj_midi.weight, frozen)


def test_graph_cache_plumbing():
    """Dropout on (TINY_CONFIG, 0.1), remat on: one graph per (rows, frames,
    notes) bucket, captured on its second visit, its dropout generators
    registered (two a site: the forward's draw and the recompute's); every
    step equal to the eager dispatch's bit for bit; a replay's logs are
    copies, which a later replay of the same graph leaves alone."""
    start = MIDIExtractionTask(dict(TINY_CONFIG), device="cpu").init_state().model.state_dict()
    rng = np.random.default_rng(3)
    buckets = {
        "a": [make_item(rng, 50 - 7 * i, 4) for i in range(3)],          # (4, 64, 8)
        "b": [make_item(rng, 70 - 9 * i, 6) for i in range(3)],          # (4, 96, 8)
        "c": [make_item(rng, 50 - 5 * i, 4) for i in range(5)],          # (8, 64, 8)
        "d": [make_item(rng, 50 - 7 * i, 12 - i) for i in range(3)],     # (4, 64, 16)
    }
    order = "aabcabdcdd"
    runs = {}
    for dispatch in ("eager", "graph"):
        task = MIDIExtractionTask(dict(TINY_CONFIG), device="cpu")
        captures = stand_in(task) if dispatch == "graph" else None
        state = task.init_state()
        state.model.load_state_dict(start)
        kinds, logs = [], []
        for name in order:
            out = task.train_step(state, task.collate(buckets[name]))
            kinds.append(task.last_dispatch)
            logs.append(out)
            if task.last_graph is not None:
                static = task.last_graph.out
                assert all(out[k].data_ptr() != static[k].data_ptr() for k in out)
        runs[dispatch] = (task, state, logs, kinds, captures)
    task, state, logs, kinds, captures = runs["graph"]
    assert kinds == ["eager", "capture", "eager", "eager", "replay", "capture", "eager",
                     "capture", "capture", "replay"]
    shapes = sorted((_shapes(k)["units"][:2], _shapes(k)["note_midi"][1]) for k in state.graphs)
    assert shapes == [((4, 64), 8), ((4, 64), 16), ((4, 96), 8), ((8, 64), 8)]
    sites = sum(isinstance(m, Dropout) and m.rate > 0 for m in state.model.modules())
    assert captures == [("train", 2 * sites)] * 4
    # the logs of the replays of 'a' (steps 2 and 5): copies that later
    # replays left as they were
    _, eager_state, eager_logs, _, _ = runs["eager"]
    _assert_same(logs, eager_logs, state, eager_state)
    graph = state.graphs[next(k for k in state.graphs if _shapes(k)["units"][:2] == (4, 64)
                              and _shapes(k)["note_midi"][1] == 8)].graph
    assert graph.replays == 2


def test_dropout_masks_keyed_to_seed_step_site():
    """A step's masks depend on (seed, step, site) alone: the same step from
    one start gives the same bits under either dispatch, another step
    other losses; in a remat'd layer each site draws twice (the forward and
    the recompute), in the final blocks once."""
    start = MIDIExtractionTask(dict(TINY_CONFIG), device="cpu").init_state().model.state_dict()
    batch_items = [make_item(np.random.default_rng(i), 50 - 7 * i, 4) for i in range(3)]

    def one_step(step, dispatch):
        task = MIDIExtractionTask(dict(TINY_CONFIG), device="cpu")
        if dispatch == "graph":
            stand_in(task)
        state = task.init_state()
        state.model.load_state_dict(start)
        batch = task.collate(batch_items)
        if dispatch == "graph":  # two visits: the replay is the step held
            task.train_step(state, batch)
            state.model.load_state_dict(start)
        state.step = step
        logs = task.train_step(state, batch)
        return task, state, logs

    task, state, eager = one_step(5, "eager")
    draws = {name: m.draws for name, m in state.model.named_modules() if isinstance(m, Dropout)}
    assert {d for n, d in draws.items() if n.startswith("backbone.layer_")} == {2}
    assert {d for n, d in draws.items() if not n.startswith("backbone.layer_")} == {1}
    task, state, graph = one_step(5, "graph")
    assert task.last_dispatch == "capture"
    assert all(torch.equal(eager[k], graph[k]) for k in eager)
    _, _, other = one_step(6, "eager")
    assert not torch.equal(eager["total_loss"], other["total_loss"])


def _valid_batches(task):
    rng = np.random.default_rng(31)
    return [task.collate(make_items(rng, [56, 41, 30], [8, 6, 4])),
            task.collate(make_items(rng, [70, 52], [10, 7]))]


def test_valid_step_graph_matches_eager_and_jax():
    """The valid step under the stand-in (one graph per valid bucket,
    captured on its second visit, its own pool) equals the eager valid
    step bit for bit; its losses are the JAX ``make_valid_step``'s (rtol
    1e-3) and its decode is JAX's ``valid_outputs`` of the same forward's
    outputs, as tests/test_torch_train.py's test_valid_outputs_match_jax
    holds it: counts, durations and rests exact, note values to f32
    rounding (|d| <= 1e-4)."""
    config = _config(remat=False)
    jtask, mesh, _, jstate = _jax_task(config)
    jvalid = jtask.make_valid_step(mesh)
    eager_task = MIDIExtractionTask(config, device="cpu")
    task = MIDIExtractionTask(config, device="cpu")
    captures = stand_in(task)
    state, eager_state = _from_jax(task, jstate), _from_jax(eager_task, jstate)
    kinds = []
    for batch in _valid_batches(task) * 3:
        (losses, extras) = task.valid_step(state, batch)
        kinds.append(task.last_dispatch)
        want_losses, want_extras = eager_task.valid_step(eager_state, batch)
        for key in want_losses:
            assert torch.equal(losses[key], want_losses[key]), key
        for key in want_extras:
            assert torch.equal(extras[key], want_extras[key]), key
        jlosses, _ = jvalid(jstate, shard_batch(batch, mesh))
        for key, value in jlosses.items():
            assert float(losses[key]) == pytest.approx(float(value), rel=1e-3), key
        tb = task.to_device(batch)
        with torch.no_grad():
            outputs = eager_state.model.eval()(**task.model_inputs(tb))
        eager_state.model.train()
        jbatch = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
        want = jax.jit(JaxTask(config).valid_outputs)(
            tuple(jnp.asarray(o.numpy()) for o in outputs), jbatch)
        assert int(extras["midi_acc_total"]) == int(want["midi_acc_total"]) > 0
        assert int(extras["midi_acc_correct"]) == int(want["midi_acc_correct"])
        for key in ("n_notes", "note_dur", "note_rest"):
            np.testing.assert_array_equal(extras[key].numpy(), np.asarray(want[key]),
                                          err_msg=key)
        for key in ("note_midi", "midi_pred", "midi_gt", "probs", "bounds"):
            np.testing.assert_allclose(extras[key].numpy(), np.asarray(want[key]), atol=1e-4,
                                       rtol=0, err_msg=key)
    assert kinds == ["eager", "eager", "capture", "capture", "replay", "replay"]
    assert captures == [("valid", 0), ("valid", 0)]
    assert state.model.training


def test_captured_step_needs_a_card():
    """No silent fallback: the switch refuses the graph dispatch on the CPU,
    and a task forced onto it raises at the capture."""
    task = MIDIExtractionTask(dict(TINY_CONFIG), device="cpu")
    assert task._dispatch == "eager"
    with pytest.raises(ValueError, match="captured steps run on a CUDA device"):
        set_train_dispatch(task, "graph")
    with pytest.raises(ValueError, match="unknown dispatch"):
        set_train_dispatch(task, "jit")
    set_train_dispatch(task, "eager")
    state = task.init_state()
    batch = task.collate([make_item(np.random.default_rng(2), 48, 4)])
    task._dispatch = "graph"
    task.train_step(state, batch)  # the bucket's first visit runs eagerly
    with pytest.raises(RuntimeError, match="a captured step needs a CUDA device"):
        task.train_step(state, batch)
    assert state.step == 1


def test_resume_rebinds_the_lr_bit_for_bit(tmp_path):
    """A resumed state's param groups get the task's lr tensor and the CPU's
    optimizer settings back (a checkpoint written on the card holds
    capturable groups; an older one a float lr), and 2 steps + a resume + 2
    steps under the stand-in graph dispatch equal 4 straight eager steps bit
    for bit (dropout on, keyed to the step)."""
    from some_tpu_torch.training.checkpoint import CheckpointManager
    from some_tpu_torch.training.trainer import Trainer

    rng = np.random.default_rng(5)
    items = [make_item(rng, 50 - 7 * i, 4) for i in range(3)]
    straight_task = MIDIExtractionTask(dict(TINY_CONFIG), device="cpu")
    straight = straight_task.init_state()
    first = MIDIExtractionTask(dict(TINY_CONFIG), device="cpu")
    state = first.init_state()
    batch = first.collate(items)
    logs = [straight_task.train_step(straight, batch) for _ in range(4)]
    for _ in range(2):
        first.train_step(state, batch)
    opt = state.optimizer.state_dict()
    opt["param_groups"][0].update(capturable=True, foreach=True, lr=1e-3)
    CheckpointManager(tmp_path).save(1, state.model.state_dict(), opt, None,
                                     extra_meta={"micro_step": 2, "epoch": 0,
                                                 "epoch_batch": 2})
    task = MIDIExtractionTask(dict(TINY_CONFIG, binary_data_dir=str(tmp_path)), device="cpu")
    stand_in(task)
    resumed = Trainer(task, tmp_path).restore_or_init()
    assert resumed.step == 2
    got = [task.train_step(resumed, batch) for _ in range(2)]
    assert [task.last_dispatch] == ["capture"]
    assert all(g["lr"] is resumed.lr and not g["capturable"] and not g["foreach"]
               for g in resumed.optimizer.param_groups)
    for g, want in zip(got, logs[2:]):
        assert all(torch.equal(g[k], want[k]) for k in want)
    _assert_same([], [], resumed, straight)
