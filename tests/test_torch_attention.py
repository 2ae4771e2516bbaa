"""Attention of the PyTorch port against the JAX package.

The port's plain version (what a CPU tensor runs) is held against the JAX
``_xla_attention`` on the same numpy inputs, with a padded tail and a row
whose keys are all masked. The TPU flash kernel has no CPU interpret path,
so the CUDA kernel is held against the plain version on the card
(``-m gpu``) and by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from some_tpu.ops.attention import _xla_attention
from some_tpu_torch.ops.attention import attention_bhtd, attention_plain, flash_attention


def _inputs(B, H, T, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, T), bool)
    mask[0, T * 2 // 3:] = False   # padded tail
    mask[-1] = False               # batch-padding row: no real key
    return q, k, v, mask


def _bhtd(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).transpose(1, 2)


@pytest.mark.parametrize("B,H,T,D", [(3, 2, 37, 32), (2, 4, 64, 64), (3, 1, 130, 16)])
def test_plain_matches_xla_attention(B, H, T, D):
    q, k, v, mask = _inputs(B, H, T, D, seed=T)
    scale = D ** -0.5
    want = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(mask), scale))          # [B, T, H, D]
    got = flash_attention(_bhtd(q), _bhtd(k), _bhtd(v), torch.from_numpy(mask), scale)
    got = got.transpose(1, 2).numpy()
    assert np.isfinite(got).all()
    print(f"parity attention f32: max|d| {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_plain_without_mask_and_in_bf16():
    q, k, v, mask = _inputs(2, 2, 48, 32, seed=1)
    scale = 32 ** -0.5
    want = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                                     scale))
    got = attention_plain(_bhtd(q), _bhtd(k), _bhtd(v), None, scale).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(_xla_attention(qb, kb, vb, jnp.asarray(mask), scale), np.float32)
    tb = [_bhtd(np.asarray(a, np.float32)).bfloat16() for a in (qb, kb, vb)]
    got = attention_plain(*tb, torch.from_numpy(mask), scale)
    assert got.dtype == torch.bfloat16
    # bf16 output: the two frameworks may round the f32 result differently
    np.testing.assert_allclose(got.transpose(1, 2).float().numpy(), want, atol=2e-2, rtol=0)


def test_impl_dispatch():
    q, k, v, mask = _inputs(2, 2, 16, 32, seed=2)
    args = (_bhtd(q), _bhtd(k), _bhtd(v), torch.from_numpy(mask), 0.2)
    want = attention_plain(*args)
    before = flash_attention.launches
    for impl in ("auto", "flash", "xla"):
        torch.testing.assert_close(attention_bhtd(*args, impl=impl), want, rtol=0, atol=0)
    assert flash_attention.launches == before  # the CPU runs no kernel
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attention_bhtd(*args, impl="splash")
    with pytest.raises(ValueError):
        attention_bhtd(*args, impl="nope")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernel_tolerance(want: torch.Tensor) -> torch.Tensor:
    """Allowed |kernel - plain| per element. f32: 1e-5. bf16: both versions
    round the output to bf16 (one ulp apart at worst) and round the
    probabilities to bf16 at different points (before and after normalizing),
    noise of about 2e-3 x the output's RMS: 2 bf16 ulp of |want| + 0.02 RMS."""
    if want.dtype == torch.float32:
        return torch.full_like(want, 1e-5)
    want = want.float()
    _, exponent = torch.frexp(want.abs())
    ulp = torch.ldexp(torch.ones_like(want), exponent - 8)
    return 2 * ulp + 0.02 * want.pow(2).mean().sqrt()


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,D", [(3, 2, 130, 64), (2, 8, 1000, 64), (2, 2, 77, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, B, H, T, D, dtype):
    q, k, v, mask = _inputs(B, H, T, D, seed=T)
    # strided [B, H, T, D] views of [B, T, H, D] storage, as the model passes them
    q, k, v = (_bhtd(a).to(cuda, dtype) for a in (q, k, v))
    mask = torch.from_numpy(mask).to(cuda)
    before = flash_attention.launches
    got = flash_attention(q, k, v, mask, D ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = attention_plain(q, k, v, mask, D ** -0.5)
    assert torch.isfinite(got.float()).all()
    real = mask.any(dim=1)
    for rows in (real, ~real):   # real rows, and the batch-padding row
        d = (got[rows].float() - want[rows].float()).abs()
        assert (d <= _kernel_tolerance(want[rows])).all(), float(d.max())
