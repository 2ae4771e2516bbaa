"""The fused LayerNorm -> FFN -> residual (K3) of the port against the JAX package.

The port's plain version (what a CPU tensor runs) is held against the JAX
``fused_ln_ffn_residual`` in interpret mode, the way tests/test_fused_ffn.py
runs it off the TPU, on the same numpy inputs. The CUDA kernel is held
against the plain version on the card (``-m gpu``) and by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import bf16_ulp
from some_tpu.ops.fused_ffn import fused_ln_ffn_residual as jax_fused
from some_tpu_torch.nn.conformer import ConformerBlock
from some_tpu_torch.ops import _build
from some_tpu_torch.ops import fused_ffn as F


def _weights(D, H, seed):
    """LN affine, W1 [D, H], b1, W2 [H, D], b2 in f32 (tests/test_fused_ffn.py's scales)."""
    rng = np.random.default_rng(seed)
    return [(np.abs(rng.standard_normal(D)) + 0.5).astype(np.float32),
            (rng.standard_normal(D) * 0.1).astype(np.float32),
            (rng.standard_normal((D, H)) * 0.05).astype(np.float32),
            (rng.standard_normal(H) * 0.1).astype(np.float32),
            (rng.standard_normal((H, D)) * 0.05).astype(np.float32),
            (rng.standard_normal(D) * 0.1).astype(np.float32)]


@pytest.mark.parametrize("B,T", [(2, 256), (3, 77)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(B, T, dtype):
    """D 64, H 256; 3 x 77 rows are no multiple of any block. f32: atol 2e-5,
    rtol 1e-5 (tests/test_fused_ffn.py's); bf16: within 2 bf16 ulp of |want|
    (the two sum in another order, and a hidden value may round to bf16 on
    the other side of a tie)."""
    D, H = 64, 256
    rng = np.random.default_rng(B * T)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    weights = _weights(D, H, seed=T)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(jax_fused(jx, *weights, interpret=True), np.float32)
    xt = torch.from_numpy(np.array(jx, np.float32)).to(getattr(torch, dtype))
    got = F.fused_ln_ffn_residual(xt, *(torch.from_numpy(w) for w in weights))
    assert got.dtype == xt.dtype and got.shape == xt.shape
    got = got.float().numpy()
    print(f"fused FFN plain vs JAX {dtype} [{B},{T},{D}]: max|d| {np.abs(got - want).max():.3g}")
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    else:
        ulp = bf16_ulp(torch, torch.from_numpy(want)).numpy()
        assert (np.abs(got - want) <= 2 * ulp).all()


def test_dispatch_and_checks():
    """A CPU tensor runs the plain version and launches nothing; 'plain' is
    the same anywhere; an unknown impl, an unsupported width and a raw launch
    on a tensor that needs a gradient raise before any build."""
    D, H = 64, 256
    x = torch.randn(2, 5, D)
    weights = [torch.from_numpy(w) for w in _weights(D, H, seed=1)]
    before = F.fused_ln_ffn_residual.launches
    want = F.fused_ln_ffn_residual_plain(x, *weights)
    for impl in ("auto", "plain"):
        torch.testing.assert_close(F.fused_ln_ffn_residual(x, *weights, impl=impl), want,
                                   rtol=0, atol=0)
    assert F.fused_ln_ffn_residual.launches == before
    with pytest.raises(ValueError, match="impl"):
        F.fused_ln_ffn_residual(x, *weights, impl="nope")
    with pytest.raises(RuntimeError, match="no backward"):
        F._launch(x.requires_grad_(), *weights, 1e-5, 0.5)
    odd = [torch.from_numpy(w) for w in _weights(48, 192, seed=2)]
    with torch.no_grad(), pytest.raises(ValueError, match="built for"):
        F._launch(torch.randn(2, 5, 48), *odd, 1e-5, 0.5)


def test_fused_block_matches_unfused_in_eval_and_trains_unfused():
    """A conformer block with ``fuse_ffn``: eval within 5e-6 of the unfused
    block in f32 (as tests/test_fused_ffn.py holds the JAX model), training
    mode runs the unfused modules (the same output as the unfused block)."""
    torch.manual_seed(0)
    fused = ConformerBlock(64, 7, 2, 32, torch.float32, fuse_ffn=True)
    plain = ConformerBlock(64, 7, 2, 32, torch.float32)
    with torch.no_grad():
        for p in fused.parameters():
            p.normal_(0, 0.2)
    plain.load_state_dict(fused.state_dict())
    x = torch.randn(2, 40, 64)
    mask = torch.ones(2, 40, dtype=torch.bool)
    mask[1, 29:] = False
    with torch.no_grad():
        torch.testing.assert_close(fused.eval()(x, mask), plain.eval()(x, mask),
                                   atol=5e-6, rtol=0)
        torch.testing.assert_close(fused.train()(x, mask), plain.train()(x, mask),
                                   atol=0, rtol=0)


def test_fused_ffn_bf16_refuses_misaligned_rows():
    """The bf16 kernel loads x's rows and the weights' rows with TMA, which
    takes 16-byte aligned rows: a bf16 x 2 bytes off a 16-byte boundary
    raises ValueError before any build or launch, with no fallback to
    another kernel; the f32 kernel has no such load, so an f32 x at the same
    offset passes the check."""
    D, H = 64, 256
    weights = [torch.from_numpy(w) for w in _weights(D, H, seed=3)]
    storage = torch.zeros(2 * 5 * D + 1, dtype=torch.bfloat16)
    shifted = storage[1:].view(2, 5, D)
    assert shifted.data_ptr() % 16 == 2
    before = F.fused_ln_ffn_residual.launches
    with torch.no_grad(), pytest.raises(ValueError, match="16-byte"):
        F._launch(shifted, *weights, 1e-5, 0.5)
    assert F.fused_ln_ffn_residual.launches == before
    _build.check_rows_aligned("fused_ln_ffn_residual",
                              torch.zeros(2 * 5 * D + 1)[1:].view(-1, D))
