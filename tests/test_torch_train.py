"""The port's training path against the JAX package's, on the CPU.

Small geometry (1 layer, dim 32, 2 x 16 heads, k 7, 16 input features, 32
bins); inputs from numpy seeds go through both. The JAX side runs its own
train step (``MIDIExtractionTask.make_train_step``); the port runs the plain
versions of its kernels, which is what a CPU tensor takes. Each test states
its tolerance.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from some_tpu.nn.conformer import MaskedBatchNorm as JaxBatchNorm
from some_tpu.ops.attention import _xla_attention
from some_tpu.ops.depthwise import depthwise_conv1d as jax_depthwise
from some_tpu.parallel.mesh import make_mesh, shard_batch
from some_tpu.training import checkpoint as jax_ckpt
from some_tpu.training import losses as jax_losses
from some_tpu.training.me_task import MIDIExtractionTask as JaxTask
from some_tpu.training.schedules import WarmupLR as JaxWarmupLR
from some_tpu_torch.compat.from_jax import jax_params_to_state_dict
from some_tpu_torch.nn.conformer import MaskedBatchNorm
from some_tpu_torch.ops.attention import attention_plain
from some_tpu_torch.ops.depthwise import depthwise_conv1d_dw_plain, depthwise_conv1d_plain
from some_tpu_torch.training import losses, optimizers, schedules
from some_tpu_torch.training.me_task import MIDIExtractionTask
from some_tpu_torch.training.trainer import Trainer
from tests.test_train_parity import make_items, parity_config
from tests.test_training import TINY_CONFIG, make_item

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


# ---- the kernels' plain backward against jax.grad ----

@pytest.mark.parametrize("B,T,C,k,impl", [(2, 128, 40, 7, "pallas_interpret"),
                                          (2, 128, 40, 7, "xla"), (1, 45, 24, 31, "xla")])
def test_depthwise_grad_matches_jax(B, T, C, k, impl):
    """f32, random cotangent: |d| <= 2e-5 (sums of T products in another order)."""
    rng = np.random.default_rng(T + k)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = (rng.standard_normal((k, C)) * 0.3).astype(np.float32)
    g = rng.standard_normal((B, T, C)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_depthwise(a, b, impl), jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    dx, dw = torch.autograd.grad(depthwise_conv1d_plain(xt, wt), (xt, wt), torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=2e-5, rtol=0)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), atol=2e-5 * np.sqrt(B * T), rtol=0)
    # the plain version of the weight-gradient kernel: the VJP's own formula
    dw_plain = depthwise_conv1d_dw_plain(torch.from_numpy(x), torch.from_numpy(g), k)
    np.testing.assert_allclose(dw_plain.numpy(), np.asarray(want_dw), atol=2e-5 * np.sqrt(B * T),
                               rtol=0)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_attention_grad_matches_jax(dtype, tol):
    """A padded tail, an all-masked row and a random cotangent. f32: |d| <=
    2e-5; bf16: |d| <= 3e-2 x RMS of the JAX gradient (the two round P and
    the products to bf16 at other points). Masked keys get exactly 0."""
    B, T, H, D = 3, 40, 2, 16
    rng = np.random.default_rng(9)
    q, k, v, g = (rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(4))
    mask = np.ones((B, T), bool)
    mask[0, 29:] = False
    mask[2] = False
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    _, vjp = jax.vjp(lambda a, b, c: _xla_attention(a, b, c, jnp.asarray(mask), D ** -0.5),
                     jq, jk, jv)
    wants = [np.asarray(w, np.float32) for w in vjp(jnp.asarray(g, jdt))]
    tdt = getattr(torch, dtype)
    ts = [torch.from_numpy(np.array(a, np.float32)).to(tdt).transpose(1, 2).requires_grad_()
          for a in (jq, jk, jv)]
    out = attention_plain(*ts, torch.from_numpy(mask), D ** -0.5)
    gt = torch.from_numpy(np.array(jnp.asarray(g, jdt), np.float32)).to(tdt).transpose(1, 2)
    grads = torch.autograd.grad(out, ts, gt)
    for name, got, want in zip("qkv", grads, wants):
        got = got.transpose(1, 2).float().numpy()
        scale = 1.0 if dtype == "float32" else float(np.sqrt((want ** 2).mean()))
        np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0, err_msg=name)
    dq, dk = (t.transpose(1, 2).float().numpy() for t in grads[:2])
    assert (dq[2] == 0).all() and (dk[2] == 0).all() and (dk[0, 29:] == 0).all()


# ---- model pieces in train mode ----

def test_masked_batchnorm_train_matches_jax():
    """Outputs and running statistics after two masked training calls: f32,
    |d| <= 1e-5."""
    rng = np.random.default_rng(4)
    mask = np.ones((3, 20), bool)
    mask[1, 12:] = False
    mask[2] = False
    bn = JaxBatchNorm()
    variables = _np(bn.init(jax.random.PRNGKey(0), np.zeros((3, 20, 8), np.float32)))
    variables["params"] = {"scale": rng.uniform(0.5, 2, 8).astype(np.float32),
                           "bias": rng.normal(size=8).astype(np.float32)}
    ours = MaskedBatchNorm(8).train()
    ours.weight.data = torch.from_numpy(variables["params"]["scale"])
    ours.bias.data = torch.from_numpy(variables["params"]["bias"])
    for call in range(2):
        x = (rng.standard_normal((3, 20, 8)) * 3 + 1).astype(np.float32)
        want, updated = bn.apply(variables, x, mask=mask, use_running_average=False,
                                 mutable=["batch_stats"])
        variables["batch_stats"] = _np(updated["batch_stats"])
        got = ours(torch.from_numpy(x), torch.from_numpy(mask))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours.running_mean.numpy(), variables["batch_stats"]["mean"],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours.running_var.numpy(), variables["batch_stats"]["var"],
                               atol=1e-5, rtol=0)


def test_losses_and_schedule_match_jax():
    """Loss functions: f32, rtol 1e-6. WarmupLR: equal in f32; the cosine
    schedule rtol 1e-6 (numpy's and XLA's f32 cosine may differ in the last
    bit)."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 30, 12)).astype(np.float32) * 4
    target = rng.random((2, 30, 12)).astype(np.float32)
    pred, tb = rng.random((2, 30)).astype(np.float32), (rng.random((2, 30)) < 0.2)
    frame_w = (np.arange(30) < 23).astype(np.float32)
    pairs = [
        (losses.bce_with_logits_elementwise(torch.from_numpy(logits), torch.from_numpy(target)),
         jax_losses.bce_with_logits_elementwise(logits, target)),
        (losses.binary_emd_per_row(torch.from_numpy(pred), torch.from_numpy(tb).float()),
         jax_losses.binary_emd_per_row(pred, tb.astype(np.float32))),
        (losses.binary_emd_per_row_masked(torch.from_numpy(pred), torch.from_numpy(tb).float(),
                                          torch.from_numpy(frame_w), torch.tensor(23.0)),
         jax_losses.binary_emd_per_row_masked(pred, tb.astype(np.float32), frame_w,
                                              jnp.float32(23))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    midi = rng.uniform(40, 60, (2, 30)).astype(np.float32)
    rest_p, rest_g = rng.random((2, 30)) < 0.3, rng.random((2, 30)) < 0.3
    got = losses.midi_accuracy_counts(torch.from_numpy(midi), torch.from_numpy(rest_p),
                                      torch.from_numpy(midi + 0.3), torch.from_numpy(rest_g),
                                      mask=torch.from_numpy(tb))
    want = jax_losses.midi_accuracy_counts(midi, rest_p, midi + 0.3, rest_g, mask=tb)
    assert [int(a) for a in got] == [int(a) for a in want]
    for ws, min_lr in ((100, 1e-5), (0, 2e-5), (4, 1e-5)):
        ours = schedules.WarmupLR(lr=1e-4, warmup_steps=ws, min_lr=min_lr)
        theirs = JaxWarmupLR(lr=1e-4, warmup_steps=ws, min_lr=min_lr)
        for step in (0, 1, 3, 99, 100, 5000, 10_000_000):
            assert ours(step) == float(theirs(step)), (ws, step)
    from some_tpu.training.schedules import WarmupCosineSchedule

    ours = schedules.build_schedule({"scheduler_cls": "utils.training_utils.WarmupCosineSchedule",
                                     "warmup_steps": 10, "t_total": 100, "eta_min": 0.1}, 1e-3)
    theirs = WarmupCosineSchedule(lr=1e-3, warmup_steps=10, t_total=100, eta_min=0.1)
    for step in (0, 5, 10, 40, 99, 150):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-6), step


def test_clip_and_adamw_match_optax():
    """clip_by_global_norm + adamw over 4 steps with the lr of a schedule,
    the norm above and below the limit: f32, |d| <= 1e-6."""
    rng = np.random.default_rng(6)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    sched = JaxWarmupLR(lr=1e-2, warmup_steps=3, min_lr=1e-5)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(sched, b1=0.9, b2=0.98, eps=1e-8, weight_decay=0.01))
    jparams = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = optimizers.build_optimizer({"optimizer_cls": "torch.optim.AdamW", "lr": 1e-2,
                                      "beta1": 0.9, "beta2": 0.98, "weight_decay": 0.01}, tparams)
    ours_sched = schedules.WarmupLR(lr=1e-2, warmup_steps=3, min_lr=1e-5)
    for step, scale in enumerate((3.0, 0.05, 2.0, 0.01)):
        grads = [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
        updates, opt_state = update([jnp.asarray(g) for g in grads], opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, grads):
            p.grad = torch.from_numpy(g.copy())
        norm = optimizers.clip_by_global_norm_([p.grad for p in tparams], 1.0)
        assert float(norm) == pytest.approx(float(optax.global_norm(grads)), rel=1e-6)
        for group in opt.param_groups:
            group["lr"] = ours_sched(step)
        opt.step()
        for p, j in zip(tparams, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), atol=1e-6, rtol=0)


# ---- the train step against the JAX train step ----

def _config(remat=True, accum=1, grid=32):
    config = parity_config()
    config.update(use_remat=remat, accumulate_grad_batches=accum, frame_bucket_grid=grid)
    return config


_JAX_STEPS = {}


def _jax_task(config):
    """One JAX task, compiled train step and initial state per distinct
    config in this module (the step does not donate, so the state is
    shared)."""
    key = repr(sorted(config.items()))
    if key not in _JAX_STEPS:
        task = JaxTask(config)
        mesh = make_mesh(jax.devices()[:1])
        _JAX_STEPS[key] = (task, mesh, task.make_train_step(mesh, donate=False),
                           task.init_state())
    return _JAX_STEPS[key]


def _ragged_batches(task, n, seed):
    """Rows of 56, 41 and 30 real frames: a 64-frame bucket and a fourth,
    padding row."""
    rng = np.random.default_rng(seed)
    return [task.collate(make_items(rng, [56, 41, 30], [8, 6, 4])) for _ in range(n)]


def assert_state_matches(model, jax_state, rms_tol=1e-4, p999_tol=2e-3):
    """Parameters as tests/test_train_parity.py holds them (RMS, share above
    1e-4, 99.9th percentile: AdamW's first updates are lr * sign(g), so a
    parameter whose gradient is float noise walks at lr scale in both); the
    BatchNorm statistics elementwise, |d| <= 1e-4 + 1e-4 |want|."""
    want = jax_params_to_state_dict(_np(jax_state.params), _np(jax_state.batch_stats))
    got = model.state_dict()
    assert set(got) == set(want)
    diffs = []
    for key, ref in want.items():
        ours = got[key].detach().float()
        if "running_" in key:
            torch.testing.assert_close(ours, ref, atol=1e-4, rtol=1e-4, msg=key)
        else:
            diffs.append((ours - ref).abs().flatten())
    d = torch.cat(diffs).double().numpy()
    assert np.sqrt((d ** 2).mean()) <= rms_tol
    assert (d > 1e-4).mean() <= 0.01
    assert np.quantile(d, 0.999) <= p999_tol


@pytest.mark.parametrize("remat", [True, False])
def test_init_is_bit_identical_to_jax(remat):
    config = _config(remat=remat)
    want = JaxTask(config).init_state()
    port = MIDIExtractionTask(config, device="cpu").init_state()
    got = port.model.state_dict()
    for key, ref in jax_params_to_state_dict(_np(want.params), _np(want.batch_stats)).items():
        assert torch.equal(got[key], ref), key


@pytest.mark.parametrize("remat", [True, False])
def test_train_steps_match_jax(remat):
    """3 steps, f32, dropout 0, a ragged batch with a padding row: losses rtol
    1e-3, grad norms rtol 2e-3 (tests/test_train_parity.py), then the state.
    Both port variants are held to one JAX step without remat (remat changes
    what is stored, not the arithmetic; JAX's remat init draws in another
    order, so the port starts from that step's initial weights)."""
    jtask, mesh, jstep, jstate = _jax_task(_config(remat=False))
    task = MIDIExtractionTask(_config(remat=remat), device="cpu")
    state = task.init_state()
    state.model.load_state_dict(jax_params_to_state_dict(_np(jstate.params),
                                                         _np(jstate.batch_stats)))
    for batch in _ragged_batches(task, 3, seed=13):
        assert batch["units"].shape[:2] == (4, 64) and batch["batch_mask"].sum() == 3
        jstate, jlogs = jstep(jstate, shard_batch(batch, mesh))
        logs = task.train_step(state, batch)
        for key in ("midi_loss", "bound_loss", "total_loss"):
            assert float(logs[key]) == pytest.approx(float(jlogs[key]), rel=1e-3, abs=1e-6), key
        assert float(logs["grad_norm"]) == pytest.approx(float(jlogs["grad_norm"]), rel=2e-3)
    assert state.step == int(jstate.step) == 3
    assert_state_matches(state.model, jstate)


def test_grad_accumulation_matches_multisteps():
    """accumulate_grad_batches 2 (optax.MultiSteps): 4 micro-steps, 2 updates;
    the logged micro-batch losses as above, then the state."""
    config = _config(remat=False, accum=2)
    jtask, mesh, jstep, jstate = _jax_task(config)
    task = MIDIExtractionTask(config, device="cpu")
    state = task.init_state()
    for batch in _ragged_batches(task, 4, seed=17):
        jstate, jlogs = jstep(jstate, shard_batch(batch, mesh))
        logs = task.train_step(state, batch)
        assert float(logs["total_loss"]) == pytest.approx(float(jlogs["total_loss"]), rel=1e-3)
        assert float(logs["grad_norm"]) == pytest.approx(float(jlogs["grad_norm"]), rel=2e-3)
    assert state.accumulator is None and state.step == 4
    assert_state_matches(state.model, jstate)


@pytest.mark.parametrize("accum,steps", [(1, 2), (2, 3)])
def test_resume_from_jax_checkpoint_takes_the_same_next_step(tmp_path, accum, steps):
    """A JAX checkpoint (weights, BatchNorm statistics, the optax state, with
    a half-filled MultiSteps accumulation for accum 2) resumes in the port
    and takes the next step as JAX does: tolerances as above."""
    config = _config(remat=False, accum=accum)
    jtask, mesh, jstep, jstate = _jax_task(config)
    batches = _ragged_batches(jtask, steps + 1, seed=21)
    for batch in batches[:steps]:
        jstate, _ = jstep(jstate, shard_batch(batch, mesh))
    jax_ckpt.save_checkpoint(tmp_path, steps // accum, _np(jstate.params),
                             _np(jstate.batch_stats), _np(jstate.opt_state),
                             extra_meta={"micro_step": steps, "epoch": 0, "epoch_batch": steps})
    task = MIDIExtractionTask(dict(config, binary_data_dir=str(tmp_path)), device="cpu")
    state = Trainer(task, tmp_path).restore_or_init()
    assert state.step == steps
    assert (state.accumulator is not None) == (steps % accum != 0)
    jstate, jlogs = jstep(jstate, shard_batch(batches[steps], mesh))
    logs = task.train_step(state, batches[steps])
    assert float(logs["total_loss"]) == pytest.approx(float(jlogs["total_loss"]), rel=1e-3)
    assert_state_matches(state.model, jstate)


def test_remat_recompute_keeps_dropout_and_running_stats():
    """With dropout on, remat on and off give the same gradients and the
    same BatchNorm statistics (recomputed masks equal, no second running
    update): f32, |d| <= 1e-6."""
    results = []
    start = MIDIExtractionTask(dict(TINY_CONFIG), device="cpu").init_state().model.state_dict()
    for remat in (True, False):
        config = dict(TINY_CONFIG, use_remat=remat)
        task = MIDIExtractionTask(config, device="cpu")
        state = task.init_state()
        state.model.load_state_dict(start)
        batch = task.collate([make_item(np.random.default_rng(i), 50 - 7 * i, 4)
                              for i in range(3)])
        logs = [task.train_step(state, batch) for _ in range(2)]
        results.append(([float(l["total_loss"]) for l in logs], state.model.state_dict()))
    (losses_a, sd_a), (losses_b, sd_b) = results
    np.testing.assert_allclose(losses_a, losses_b, rtol=1e-6)
    for key in sd_a:
        torch.testing.assert_close(sd_a[key], sd_b[key], atol=1e-6, rtol=0, msg=key)


# ---- the trainer ----

@pytest.fixture
def tiny_dataset(tmp_path):
    from some_tpu_torch.data.indexed_dataset import IndexedDatasetWriter, save_lengths

    rng = np.random.default_rng(114514)
    data_dir = tmp_path / "binary"
    for prefix, n_items in (("train", 6), ("valid", 2)):
        lengths = []
        with IndexedDatasetWriter(data_dir, prefix) as writer:
            for _ in range(n_items):
                item = make_item(rng, int(rng.integers(40, 120)), int(rng.integers(3, 8)))
                writer.add_item(item)
                lengths.append(item["length"])
        save_lengths(data_dir, prefix, lengths)
    return data_dir


def test_resume_replays_uninterrupted_data_order(tiny_dataset, tmp_path):
    """Stop at 3, resume to 8: the same train-item reads as one 8-step run,
    and checkpoint retention keeps num_ckpt_keep (tests/test_training.py)."""
    config = dict(TINY_CONFIG, ds_workers=0, binary_data_dir=str(tiny_dataset))

    class RecordingTask(MIDIExtractionTask):
        def __init__(self, record):
            super().__init__(dict(config), device="cpu")
            self._record = record

        def load_datasets(self):
            (tds, tsz), valid = super().load_datasets()
            record = self._record

            class _Wrap:
                def __getitem__(self, i):
                    record.append(int(i))
                    return tds[i]

            return (_Wrap(), tsz), valid

    seq_a: list = []
    Trainer(RecordingTask(seq_a), tmp_path / "a").fit(max_steps=8)
    seq_b: list = []
    Trainer(RecordingTask(seq_b), tmp_path / "b").fit(max_steps=3)
    trainer = Trainer(RecordingTask(seq_b), tmp_path / "b")
    state = trainer.fit(max_steps=8)
    assert seq_b == seq_a and state.step == 8
    from some_tpu_torch.training.checkpoint import list_checkpoints

    assert [s for s, _ in list_checkpoints(tmp_path / "b")] == [6, 8]
    assert "midi_acc" in trainer.last_validation


def test_cli_trains_then_infers(tiny_dataset, tmp_path):
    """python -m some_tpu_torch.train --device cpu for 3 steps on an HDF5
    set, then python -m some_tpu_torch.infer loads its checkpoint."""
    from some_tpu.audio.wavio import save_wav
    from some_tpu_torch.config import save_yaml

    config = dict(TINY_CONFIG, binary_data_dir=str(tiny_dataset), units_encoder="mel",
                  task_cls="training.MIDIExtractionTask", pl_trainer_precision="32-true",
                  val_check_interval=100, ds_workers=1)
    save_yaml(config, tmp_path / "tiny.yaml")
    train = subprocess.run(
        [sys.executable, "-m", "some_tpu_torch.train", "--config", str(tmp_path / "tiny.yaml"),
         "--exp_name", "tiny", "--work_dir", str(tmp_path / "exp"), "--max_steps", "3",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert train.returncode == 0, train.stdout[-2000:] + train.stderr[-2000:]
    ckpt = tmp_path / "exp" / "tiny" / "model_ckpt_steps_3.ckpt"
    assert ckpt.exists() and (ckpt.parent / "config.yaml").exists()
    sr = 44100
    t = np.arange(sr * 2) / sr
    save_wav(tmp_path / "song.wav", (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32), sr)
    infer = subprocess.run(
        [sys.executable, "-m", "some_tpu_torch.infer", "--model", str(ckpt),
         "--wav", str(tmp_path / "song.wav"), "--midi", str(tmp_path / "song.mid"),
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert infer.returncode == 0, infer.stderr[-2000:]
    assert (tmp_path / "song.mid").stat().st_size > 0


def test_valid_outputs_match_jax():
    """Validation decode and midi_acc counters on the same outputs: decoded
    notes to f32 rounding (|d| <= 1e-4), counts and durations exact."""
    config = _config(remat=False)
    task = MIDIExtractionTask(config, device="cpu")
    batch = _ragged_batches(task, 1, seed=31)[0]
    rng = np.random.default_rng(31)
    logits = (rng.standard_normal((4, 64, 32)) * 3).astype(np.float32)
    bounds = (rng.random((4, 64)) < 0.1).astype(np.float32)
    jtask = JaxTask(config)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    # jitted: one compile instead of one per eager op
    want = jax.jit(jtask.valid_outputs)((jnp.asarray(logits), jnp.asarray(bounds)), jbatch)
    tb = task.to_device(batch)
    got = task.valid_outputs((torch.from_numpy(logits), torch.from_numpy(bounds)), tb)
    assert int(got["midi_acc_total"]) == int(want["midi_acc_total"]) > 0
    assert int(got["midi_acc_correct"]) == int(want["midi_acc_correct"])
    for key in ("n_notes", "note_dur", "note_rest"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key in ("note_midi", "midi_pred", "midi_gt", "probs", "bounds"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4, rtol=0,
                                   err_msg=key)
    jlosses = jax.jit(jtask.compute_losses)((jnp.asarray(logits), jnp.asarray(bounds)), jbatch)
    losses = task.compute_losses((torch.from_numpy(logits), torch.from_numpy(bounds)), tb)
    for key, value in jlosses.items():
        assert float(losses[key]) == pytest.approx(float(value), rel=1e-5), key


def test_frozen_params_get_no_update():
    """freezing_enabled + frozen_params ('model.'-prefixed as reference
    configs name them): the prefix gets no update, the rest trains."""
    config = dict(TINY_CONFIG, freezing_enabled=True,
                  frozen_params=["model.backbone.in_proj_midi"])
    task = MIDIExtractionTask(config, device="cpu")
    state = task.init_state()
    frozen0 = state.model.backbone.in_proj_midi.weight.detach().clone()
    other0 = state.model.backbone.in_proj_bound.weight.detach().clone()
    batch = task.collate([make_item(np.random.default_rng(2), 48, 4)])
    for _ in range(2):
        logs = task.train_step(state, batch)
    assert np.isfinite(float(logs["grad_norm"]))
    assert torch.equal(state.model.backbone.in_proj_midi.weight, frozen0)
    assert not torch.equal(state.model.backbone.in_proj_bound.weight, other0)


def test_sigterm_checkpoints_like_interrupt(tiny_dataset, tmp_path):
    """SIGTERM saves a checkpoint at the exact applied step and sampler
    position, like Ctrl-C, and the handler is restored after fit
    (tests/test_training.py)."""
    import os
    import signal

    from some_tpu_torch.training.checkpoint import latest_checkpoint
    from some_tpu_torch.utils.checkpoint import load_checkpoint

    config = dict(TINY_CONFIG, ds_workers=0, binary_data_dir=str(tiny_dataset))

    class PreemptedTask(MIDIExtractionTask):
        hits = 0

        def collate(self, items):
            type(self).hits += 1
            if type(self).hits == 3:  # after 2 applied steps
                os.kill(os.getpid(), signal.SIGTERM)
            return super().collate(items)

    work = tmp_path / "work"
    with pytest.raises(KeyboardInterrupt):
        Trainer(PreemptedTask(dict(config), device="cpu"), work).fit(max_steps=10)
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    meta = load_checkpoint(latest_checkpoint(work))["meta"]
    assert meta["micro_step"] == 2 and meta["epoch_batch"] == 2
    state = Trainer(MIDIExtractionTask(dict(config), device="cpu"), work).fit(max_steps=4)
    assert state.step == 4
