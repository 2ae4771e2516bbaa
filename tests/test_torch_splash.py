"""Splash attention (K4) and the opt-in kernel configuration of the port
(``attention_impl: splash``, ``fuse_ffn: true``) against the JAX package.

JAX's splash kernels run on the CPU only in interpret mode, and the package's
``_splash_kernel`` passes no ``interpret``: the module fixture swaps it for a
function that makes the same kernel (the same mask and block sizes) with
``interpret=True``. Nothing in ``some_tpu`` changes. Splash needs T to be a multiple of 128 there, so
every JAX call below runs at such a T.

The port runs on the CPU, where every kernel takes its plain version; the
CUDA kernels are held against those on the card (``-m gpu``) and by
chip_smoke.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import some_tpu.ops.attention as jax_attention
from chip_smoke import bf16_ulp, grad_tolerance
from some_tpu.nn.model import build_midi_extractor as jax_build
from some_tpu.parallel.mesh import make_mesh, shard_batch
from some_tpu.training.checkpoint import save_checkpoint
from some_tpu.training.me_task import MIDIExtractionTask as JaxTask
from some_tpu_torch.compat.from_jax import jax_params_to_state_dict, load_jax_variables
from some_tpu_torch.inference.me_infer import MIDIExtractionInference
from some_tpu_torch.nn.model import build_midi_extractor
from some_tpu_torch.ops.attention import (
    SPLASH_MASK_VALUE, attention_plain, prescale, splash_attention_bwd_dkv_plain,
    splash_attention_bwd_dq_plain, splash_attention_plain,
)
from some_tpu_torch.training.me_task import MIDIExtractionTask
from tests.test_prod_parity import make_song
from tests.test_torch_infer import CONFIG, songs, variables  # noqa: F401 (fixtures)
from tests.test_torch_train import _config, _np, assert_state_matches
from tests.test_train_parity import make_items

OPT_IN = {"attention_impl": "splash", "fuse_ffn": True}


@functools.lru_cache(maxsize=16)
def _interpreted_splash_kernel(heads: int, t: int, block_q: int, block_kv: int):
    from jax.experimental.pallas.ops.tpu.splash_attention import (
        splash_attention_kernel as sk, splash_attention_mask as sm,
    )

    mh_mask = sm.MultiHeadMask([sm.FullMask((t, t)) for _ in range(heads)])
    block_sizes = sk.BlockSizes(
        block_q=block_q, block_kv=block_kv, block_kv_compute=block_kv,
        block_q_dkv=block_q, block_kv_dkv=block_kv, block_kv_dkv_compute=block_kv,
        block_q_dq=block_q, block_kv_dq=block_kv)
    return sk.make_splash_mha(mh_mask, block_sizes=block_sizes, head_shards=1,
                              q_seq_shards=1, interpret=True)


@pytest.fixture(scope="module", autouse=True)
def interpreted_splash():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_attention, "_splash_kernel", _interpreted_splash_kernel)
        yield


def _inputs(B, H, T, D, seed, masked=True):
    """q, k, v and a cotangent [B, H, T, D] in f32, and a [B, T] mask with a
    padded tail and an all-padding row (or None)."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(4))
    if not masked:
        return q, k, v, g, None
    mask = np.ones((B, T), bool)
    mask[0, T * 2 // 3:] = False
    mask[-1] = False
    return q, k, v, g, mask


def _forward_tolerance(want: torch.Tensor) -> torch.Tensor:
    """f32: 1e-5. bf16: both round the output to bf16 once (an ulp apart at
    worst) and sum in another order: 2 bf16 ulp of |want| + 0.005 RMS(want)."""
    if want.dtype == torch.float32:
        return torch.full_like(want, 1e-5)
    w = want.float()
    return 2 * bf16_ulp(torch, w) + 0.005 * float(w.pow(2).mean().sqrt())


@pytest.mark.parametrize("B,H,T,D,masked", [(2, 2, 256, 64, True), (3, 2, 128, 32, True),
                                            (2, 2, 128, 64, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_splash_and_its_vjp(B, H, T, D, masked, dtype):
    """Forward on every row, padded queries and the all-padding row included
    (they tell segment ids from ``_xla_attention``), and the gradients of q,
    k, v against ``jax.vjp``: f32 within 1e-4 x RMS(want); bf16 within
    chip_smoke's grad_tolerance at rel 0.1 (splash's kernels round P and dS
    to bf16, the plain autograd keeps them f32)."""
    q, k, v, g, mask = _inputs(B, H, T, D, seed=T + D, masked=masked)
    scale = D ** -0.5
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    jmask = None if mask is None else jnp.asarray(mask)
    want, vjp = jax.vjp(jax.jit(lambda a, b, c: jax_attention._splash_attention_bhtd(
        a, b, c, jmask, scale)), jq, jk, jv)
    wants = vjp(jg)
    tdt = getattr(torch, dtype)
    ts = [torch.from_numpy(np.array(a, np.float32)).to(tdt).requires_grad_()
          for a in (jq, jk, jv)]
    tmask = None if mask is None else torch.from_numpy(mask)
    out = splash_attention_plain(*ts, tmask, scale)
    assert out.dtype == tdt
    want_t = torch.from_numpy(np.array(want, np.float32)).to(tdt)
    d = (out.detach().float() - want_t.float()).abs()
    print(f"splash plain vs JAX {dtype} [{B},{H},{T},{D}]: max|d| {float(d.max()):.3g}")
    assert (d <= _forward_tolerance(want_t)).all(), float(d.max())
    grads = torch.autograd.grad(out, ts, torch.from_numpy(np.array(jg, np.float32)).to(tdt))
    for name, got, w in zip("qkv", grads, wants):
        w = torch.from_numpy(np.array(w, np.float32))
        if dtype == "float32":
            tol = 1e-4 * float(w.pow(2).mean().sqrt())
        else:
            tol = grad_tolerance(torch, w.to(tdt), 0.1)
        assert ((got.float() - w).abs() <= tol).all(), (name, float((got.float() - w).abs().max()))


@pytest.mark.parametrize("B,H,T,D", [(2, 2, 256, 64), (3, 2, 128, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_splash_vjp(B, H, T, D, dtype):
    """splash_attention_bwd_dq_plain and splash_attention_bwd_dkv_plain, the
    yardsticks of K4's backward kernels, against ``jax.vjp`` of
    ``_splash_attention_bhtd``: the same pre-scaled q, the log-sum-exp of the
    f32 scores, and di = rowsum(O * dO) in f32 from JAX's own output, as
    splash takes it (``splash_attention_kernel.py:2285``); dq through the
    pre-scale as JAX's autograd carries it. Both round P and dS where splash
    rounds them, so f32 within 1e-5 x RMS(want); bf16 within 2 bf16 ulp of
    |want| + 0.004 RMS(want), for f32 sums in another order and the P or dS
    that a one-ulp lse lands on the other side of a bf16 rounding."""
    q, k, v, g, mask = _inputs(B, H, T, D, seed=T + D + 1)
    scale = D ** -0.5
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    jmask = jnp.asarray(mask)
    out, vjp = jax.vjp(jax.jit(lambda a, b, c: jax_attention._splash_attention_bhtd(
        a, b, c, jmask, scale)), jq, jk, jv)
    wants = vjp(jg)
    tdt = getattr(torch, dtype)
    tq, tk, tv, tg = (torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in (jq, jk, jv, jg))
    tmask = torch.from_numpy(mask)
    qs = prescale(tq, scale)
    same = (tmask[:, :, None] == tmask[:, None, :])[:, None]
    lse = torch.logsumexp((qs.float() @ tk.float().transpose(-1, -2)).masked_fill(
        ~same, SPLASH_MASK_VALUE), dim=-1)
    di = (torch.from_numpy(np.array(out, np.float32)) * tg.float()).sum(-1)
    dqs = splash_attention_bwd_dq_plain(qs, tk, tv, tg, lse, di, tmask)
    dk, dv = splash_attention_bwd_dkv_plain(qs, tk, tv, tg, lse, di, tmask)
    dq = dqs * float(torch.tensor(scale, dtype=tdt))
    for name, got, w in zip("qkv", (dq, dk, dv), wants):
        assert got.dtype == tdt
        w = torch.from_numpy(np.array(w, np.float32))
        rms = float(w.pow(2).mean().sqrt())
        d = (got.float() - w).abs()
        if dtype == "float32":
            tol = 1e-5 * rms
        else:
            tol = 2 * bf16_ulp(torch, w) + 0.004 * rms
        print(f"splash backward plain vs JAX vjp {dtype} [{B},{H},{T},{D}] d{name}: max|d| / RMS "
              f"{float(d.max()) / rms:.3g}, max |d|/tol {float((d / tol).max()):.3f}")
        assert (d <= tol).all(), (name, float((d / tol).max()))


def test_segment_ids_differ_from_xla_attention_on_padding_only():
    """Real queries see the same keys under both semantics; a padded query
    attends only the padded keys, and an all-padding row attends all its
    keys (one segment) where ``_xla_attention`` masks them all."""
    q, k, v, _, mask = _inputs(3, 2, 48, 32, seed=5)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    tmask = torch.from_numpy(mask)
    splash = splash_attention_plain(*args, tmask, 32 ** -0.5)
    xla = attention_plain(args[0] * float(torch.tensor(32 ** -0.5)), *args[1:], tmask, 1.0)
    torch.testing.assert_close(splash[0, :, :32], xla[0, :, :32], atol=1e-6, rtol=0)
    torch.testing.assert_close(splash[1], xla[1], atol=1e-6, rtol=0)
    pad_only = splash_attention_plain(*(a[:1, :, 32:] for a in args), None, 32 ** -0.5)
    torch.testing.assert_close(splash[0, :, 32:], pad_only[0], atol=1e-6, rtol=0)
    unmasked = splash_attention_plain(*(a[2:] for a in args), None, 32 ** -0.5)
    torch.testing.assert_close(splash[2:], unmasked, atol=1e-6, rtol=0)
    assert (splash[0, :, 32:] - xla[0, :, 32:]).abs().max() > 1e-2


GEOMETRY = {"lay": 1, "dim": 64, "use_lay_skip": True, "kernel_size": 7, "conv_drop": 0.1,
            "ffn_latent_drop": 0.1, "ffn_out_drop": 0.1, "attention_drop": 0.1,
            "attention_heads": 2, "attention_heads_dim": 32}


def test_model_with_both_opt_ins_matches_jax():
    """Eval mode, f32, T 256 with a padded tail and a padding row: every
    frame of both heads within 1e-5."""
    config = {"units_dim": 16, "midi_num_bins": 32, "midi_extractor_args": GEOMETRY}
    rng = np.random.default_rng(21)
    x = rng.standard_normal((3, 256, 16)).astype(np.float32)
    mask = np.ones((3, 256), bool)
    mask[1, 170:] = False
    mask[2] = False
    jm = jax_build(dict(config, **OPT_IN))
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3), x[:1], mask=mask[:1]))
    stats = jax.tree_util.tree_map(lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32),
                                   v["batch_stats"])
    variables = {"params": v["params"], "batch_stats": stats}
    want = jm.apply(variables, x, mask=mask, sig=True)
    model = build_midi_extractor(dict(config, **OPT_IN)).eval()
    load_jax_variables(model, variables["params"], variables["batch_stats"])
    with torch.no_grad():
        got = model(torch.from_numpy(x), mask=torch.from_numpy(mask), sig=True)
    for g, w in zip(got, want):
        d = np.abs(g.numpy() - np.asarray(w))
        print(f"opt-in model vs JAX f32: max|d| {d.max():.3g}")
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_cli_with_both_opt_ins_matches_jax_cli(tmp_path, variables, songs):  # noqa: F811
    """f32, the same notes. Each song slices into one chunk of a 512-frame
    bucket (JAX splash refuses T % 128 != 0, as at the default bucket 192)."""
    from click.testing import CliRunner

    import infer as jax_cli
    from some_tpu.utils.midi_file import MidiFile
    from some_tpu_torch.infer import main as port_cli

    config = dict(CONFIG, pl_trainer_precision="32-true", **OPT_IN)
    ckpt = save_checkpoint(tmp_path, 1000, variables["params"], variables["batch_stats"])
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(config))
    for i, wav in enumerate(songs):
        jax_mid, port_mid = tmp_path / f"jax{i}.mid", tmp_path / f"port{i}.mid"
        result = CliRunner().invoke(jax_cli.infer, ["--model", str(ckpt), "--wav", str(wav),
                                                    "--midi", str(jax_mid)])
        assert result.exit_code == 0, result.output
        port_cli(["--model", str(ckpt), "--wav", str(wav), "--midi", str(port_mid),
                  "--device", "cpu"])
        want = MidiFile.load(jax_mid).notes()
        assert len(want) > 0
        assert MidiFile.load(port_mid).notes() == want


def test_train_steps_with_splash_match_jax():
    """3 steps, f32, dropout 0, remat on, ``attention_impl: splash``: a ragged
    batch (rows of 120, 90 and 60 frames in a 128-frame bucket, and a padding
    row). The losses read the padded frames below ``t_real``, where segment
    ids and ``_xla_attention`` differ. Losses rtol 1e-3, grad norms rtol 2e-3,
    then the state, as test_train_steps_match_jax holds them. JAX's
    ``init_state`` runs the model at T 64 by default, which splash refuses:
    it gets a 128-frame example batch (the parameters do not depend on T)."""
    config = dict(_config(remat=True, grid=128), attention_impl="splash")
    jtask = JaxTask(config)
    mesh = make_mesh(jax.devices()[:1])
    jstep = jtask.make_train_step(mesh, donate=False)
    example = {"units": np.zeros((1, 128, config["units_dim"]), np.float32),
               "pitch": np.zeros((1, 128), np.float32), "mask": np.ones((1, 128), bool)}
    jstate = jtask.init_state(example_batch=example)
    task = MIDIExtractionTask(config, device="cpu")
    state = task.init_state()
    state.model.load_state_dict(jax_params_to_state_dict(_np(jstate.params),
                                                         _np(jstate.batch_stats)))
    rng = np.random.default_rng(23)
    for _ in range(3):
        batch = task.collate(make_items(rng, [120, 90, 60], [8, 6, 4]))
        assert batch["units"].shape[:2] == (4, 128) and batch["batch_mask"].sum() == 3
        jstate, jlogs = jstep(jstate, shard_batch(batch, mesh))
        logs = task.train_step(state, batch)
        for key in ("midi_loss", "bound_loss", "total_loss"):
            assert float(logs[key]) == pytest.approx(float(jlogs[key]), rel=1e-3, abs=1e-6), key
        assert float(logs["grad_norm"]) == pytest.approx(float(jlogs["grad_norm"]), rel=2e-3)
    assert state.step == int(jstate.step) == 3
    assert_state_matches(state.model, jstate)


def test_bucket_log_names_the_path(capsys, variables):  # noqa: F811
    """The engine says once per bucket which attention path and whether the
    fused FFN run: the plain versions on the CPU, the kernels on the card."""
    state = jax_params_to_state_dict(variables["params"], variables["batch_stats"])
    engine = MIDIExtractionInference.from_state_dict(dict(CONFIG, **OPT_IN), state,
                                                     dtype=torch.float32, device="cpu")
    engine.infer([make_song(1000)[:100 * 512]])
    assert "| bucket T=128: attention=plain, fused FFN" in capsys.readouterr().err
    engine.device = torch.device("cuda")  # only the message reads it
    for config, line in ((dict(CONFIG, **OPT_IN), "attention=splash kernel, fused FFN"),
                         (CONFIG, "attention=flash kernel"),
                         (dict(CONFIG, attention_impl="xla"), "attention=plain")):
        engine.config, engine._logged_buckets = config, set()
        engine._log_bucket_path(256)
        assert capsys.readouterr().err == f"| bucket T=256: {line}\n"
