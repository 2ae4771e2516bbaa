"""Depthwise conv of the PyTorch port against the JAX package.

The port's plain version (what a CPU tensor runs) is held against the JAX
``depthwise_conv1d`` with ``impl='pallas_interpret'`` (the Pallas kernel in
interpret mode) and ``impl='xla'`` on the same numpy inputs. The CUDA kernel
itself is held against the plain version on the card (``-m gpu``) and by
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from some_tpu.ops.depthwise import depthwise_conv1d as jax_depthwise
from some_tpu_torch.ops.depthwise import depthwise_conv1d, depthwise_conv1d_plain


def _inputs(B, T, C, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = (rng.standard_normal((k, C)) * 0.1).astype(np.float32)
    return x, w


def _bf16_ulp(ref: np.ndarray) -> np.ndarray:
    _, exponent = np.frexp(np.abs(ref.astype(np.float32)))
    return np.ldexp(1.0, exponent - 8)


@pytest.mark.parametrize("B,T,C,k,impls", [
    (2, 128, 300, 31, ("pallas_interpret", "xla")),   # C not a multiple of 256
    (1, 256, 64, 7, ("pallas_interpret", "xla")),
    (2, 37, 40, 7, ("xla",)),                         # odd T: the TPU kernel needs T % 8
    (1, 101, 520, 31, ("xla",)),
])
def test_plain_matches_jax_f32(B, T, C, k, impls):
    x, w = _inputs(B, T, C, k, seed=T + C)
    got = depthwise_conv1d(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    for impl in impls:
        want = np.asarray(jax_depthwise(jnp.asarray(x), jnp.asarray(w), impl))
        print(f"parity depthwise f32 {impl}: max|d| {np.abs(got - want).max():.3g}")
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=impl)


@pytest.mark.parametrize("B,T,C,k,impl", [
    (2, 128, 300, 31, "pallas_interpret"),
    (1, 64, 48, 7, "pallas_interpret"),
    (1, 45, 40, 7, "xla"),
])
def test_plain_matches_jax_bf16_within_one_ulp(B, T, C, k, impl):
    x, w = _inputs(B, T, C, k, seed=7 * T + C)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(jax_depthwise(xb, wb, impl), np.float32)
    got = depthwise_conv1d(torch.from_numpy(np.asarray(xb, np.float32)).bfloat16(),
                           torch.from_numpy(np.asarray(wb, np.float32)).bfloat16())
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    print(f"parity depthwise bf16 {impl}: max|d| {diff.max():.3g}")
    assert (diff <= _bf16_ulp(want)).all(), diff.max()


def test_wrapper_dispatch_on_cpu():
    x = torch.randn(1, 16, 8)
    w = torch.randn(3, 8)
    before = depthwise_conv1d.launches
    torch.testing.assert_close(depthwise_conv1d(x, w), depthwise_conv1d_plain(x, w),
                               rtol=0, atol=0)
    torch.testing.assert_close(depthwise_conv1d(x, w, impl="plain"),
                               depthwise_conv1d_plain(x, w), rtol=0, atol=0)
    assert depthwise_conv1d.launches == before  # the CPU runs no kernel
    with pytest.raises(ValueError, match="odd"):
        depthwise_conv1d(x, torch.randn(4, 8))
    with pytest.raises(ValueError, match="unknown depthwise impl"):
        depthwise_conv1d(x, w, impl="xla")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,k", [((2, 1000, 300), 31), ((1, 77, 512), 7), ((3, 64, 5), 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, shape, k, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    w = (torch.randn((k, shape[2]), generator=gen, device=cuda) * 0.1).to(dtype)
    before = depthwise_conv1d.launches
    got = depthwise_conv1d(x, w)
    torch.cuda.synchronize()
    assert depthwise_conv1d.launches == before + 1
    # same arithmetic in the same order: bit for bit
    torch.testing.assert_close(got, depthwise_conv1d_plain(x, w), rtol=0, atol=0)
