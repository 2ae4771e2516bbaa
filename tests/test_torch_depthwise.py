"""Depthwise conv of the PyTorch port against the JAX package.

The port's plain version (what a CPU tensor runs) is held against the JAX
``depthwise_conv1d`` with ``impl='pallas_interpret'`` (the Pallas kernel in
interpret mode) and ``impl='xla'`` on the same numpy inputs, forward and
backward (the JAX custom VJP). The CUDA kernel itself is held against the
plain version on the card (``-m gpu``) and by chip_smoke.py; JAX is imported
only by the tests that use it, so those run on a machine with a card and no
JAX:

    python -m pytest --noconftest tests/test_torch_depthwise.py -q -m gpu
"""
import numpy as np
import pytest
import torch

from some_tpu_torch.ops.depthwise import (
    depthwise_conv1d, depthwise_conv1d_dw_plain, depthwise_conv1d_dx, depthwise_conv1d_plain,
)


def _jax():
    """jax, jax.numpy and the JAX package's depthwise_conv1d."""
    import jax
    import jax.numpy as jnp

    from some_tpu.ops.depthwise import depthwise_conv1d as jax_depthwise
    return jax, jnp, jax_depthwise


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
    _, jnp, jax_depthwise = _jax()
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
    _, jnp, jax_depthwise = _jax()
    x, w = _inputs(B, T, C, k, seed=7 * T + C)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(jax_depthwise(xb, wb, impl), np.float32)
    got = depthwise_conv1d(torch.from_numpy(np.asarray(xb, np.float32)).bfloat16(),
                           torch.from_numpy(np.asarray(wb, np.float32)).bfloat16())
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    print(f"parity depthwise bf16 {impl}: max|d| {diff.max():.3g}")
    assert (diff <= _bf16_ulp(want)).all(), diff.max()


def _f32_ulp(ref: np.ndarray) -> np.ndarray:
    _, exponent = np.frexp(np.abs(ref.astype(np.float32)))
    return np.ldexp(1.0, exponent - 24)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,C,k,impl", [
    (2, 128, 48, 7, "pallas_interpret"),
    (2, 128, 48, 31, "pallas_interpret"),
    (1, 128, 300, 7, "pallas_interpret"),
    (2, 128, 300, 31, "pallas_interpret"),
    (2, 128, 48, 7, "xla"),
    (1, 77, 48, 31, "xla"),                           # T not a multiple of 8
    (1, 128, 300, 7, "xla"),
    (2, 128, 300, 31, "xla"),
])
def test_backward_matches_jax_vjp(B, T, C, k, impl, dtype):
    """K1's backward: the port's plain autograd (dx and dw) and
    depthwise_conv1d_dw_plain against jax.vjp of the JAX custom VJP. f32: dx
    within 1e-5, dw within 2 ulp + 1e-6 x RMS(dw) (sums over B*T in another
    order). bf16: both within 1 bf16 ulp + 1e-2 x RMS, since the two sum in
    different orders before their one rounding to bf16."""
    jax, jnp, jax_depthwise = _jax()
    rng = np.random.default_rng(11 * T + C + k)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w = (rng.standard_normal((k, C)) * 0.1).astype(np.float32)
    g = rng.standard_normal((B, T, C)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xj, wj, gj = (jnp.asarray(a, jdt) for a in (x, w, g))
    _, vjp = jax.vjp(lambda a, b: jax_depthwise(a, b, impl), xj, wj)
    want_dx, want_dw = (np.asarray(a, np.float32) for a in vjp(gj))

    tdt = getattr(torch, dtype)
    xt, wt, gt = (torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in (xj, wj, gj))
    xt.requires_grad_()
    wt.requires_grad_()
    dx, dw = torch.autograd.grad(depthwise_conv1d(xt, wt), (xt, wt), gt)
    assert dx.dtype == dw.dtype == tdt
    got = {"dx": dx.float().numpy(), "dw": dw.float().numpy(),
           "dw_plain": depthwise_conv1d_dw_plain(xt.detach(), gt, k).float().numpy()}
    for name, value in got.items():
        want = want_dx if name == "dx" else want_dw
        diff = np.abs(value - want)
        rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
        if dtype == "float32":
            tol = 1e-5 if name == "dx" else 2 * _f32_ulp(want) + 1e-6 * rms
        else:
            tol = _bf16_ulp(want) + 1e-2 * rms
        print(f"vjp depthwise {dtype} {impl} k={k} C={C} {name}: max|d| {diff.max():.3g}, "
              f"rms {rms:.3g}, max |d|/tol {float((diff / tol).max()):.3g}")
        assert (diff <= tol).all(), (name, float(diff.max()), rms)


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


def at_odd_offset(t: torch.Tensor) -> torch.Tensor:
    """The same values as a contiguous view one element into a flat buffer:
    its rows are not 16-byte aligned, so the kernels take their masked path."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


# (shape, k, odd offset): the main paths' shapes (infer [8, 512, 512] and
# [1, 6144, 512], train [8, 2048, 512]), then ragged C and T, then views at an
# odd element offset
KERNEL_CASES = [((8, 512, 512), 31, False), ((1, 6144, 512), 31, False),
                ((8, 2048, 512), 31, False),
                ((2, 1000, 300), 31, False), ((1, 77, 512), 7, False), ((3, 64, 5), 7, False),
                ((2, 1, 300), 31, False), ((1, 37, 520), 31, False), ((2, 77, 5), 31, False),
                ((1, 1000, 520), 7, False),
                ((2, 300, 512), 31, True), ((1, 37, 300), 7, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,k,offset", KERNEL_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, shape, k, offset, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    w = (torch.randn((k, shape[2]), generator=gen, device=cuda) * 0.1).to(dtype)
    if offset:
        x = at_odd_offset(x)
    before = depthwise_conv1d.launches
    got = depthwise_conv1d(x, w)
    torch.cuda.synchronize()
    assert depthwise_conv1d.launches == before + 1
    # same arithmetic in the same order: bit for bit
    torch.testing.assert_close(got, depthwise_conv1d_plain(x, w), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,k,offset", [((8, 1024, 512), 31, False), ((2, 77, 300), 7, False),
                                            ((1, 1000, 520), 31, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dx_reads_taps_reversed(cuda, shape, k, offset, dtype):
    """dx takes the taps in reverse order from the kernel's argument, not
    from a flipped copy, and equals the plain version on w.flip(0) bit for
    bit."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    g = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    w = (torch.randn((k, shape[2]), generator=gen, device=cuda) * 0.1).to(dtype)
    if offset:
        g = at_odd_offset(g)
    before = depthwise_conv1d_dx.launches
    got = depthwise_conv1d_dx(g, w)
    torch.cuda.synchronize()
    assert depthwise_conv1d_dx.launches == before + 1
    torch.testing.assert_close(got, depthwise_conv1d_plain(g, w.flip(0)), rtol=0, atol=0)
