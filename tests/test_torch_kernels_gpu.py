"""The port's kernels, backward included, against the autograd of their plain
versions on the card.

Imports nothing of JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q -m gpu

The tests marked ``gpu`` skip without a card. The tolerances are chip_smoke.py's
(``grad_tolerance``): tied to the scale of the reference tensor. The rest run on
the CPU too: a raw launch refuses a tensor that needs a gradient instead of
returning an output with no ``grad_fn``.
"""
import numpy as np
import pytest
import torch

from chip_smoke import grad_tolerance
from some_tpu_torch.ops import attention as A
from some_tpu_torch.ops import depthwise as W


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want, rel, what):
    tol = grad_tolerance(torch, want, rel)
    ratio = float(((got.float() - want.float()).abs() / tol).max())
    assert torch.isfinite(got.float()).all(), what
    assert ratio <= 1.0, (what, ratio)


def test_raw_launches_refuse_grad():
    x = torch.randn(1, 8, 4, requires_grad=True)
    w = torch.randn(7, 4)
    with pytest.raises(RuntimeError, match="no backward"):
        W._launch(x, w, W.depthwise_conv1d)
    q = torch.randn(1, 2, 8, 32, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        A._launch(q, q.detach(), q.detach(), None, 0.1)
    with pytest.raises(RuntimeError, match="no backward"):
        A.flash_attention_fwd_res(q, q.detach(), q.detach(), None, 0.1)
    with torch.no_grad():  # the inference path: no gradient wanted, nothing refused
        with pytest.raises(RuntimeError, match="nvcc|CUDA|cuda"):
            W._launch(x, w, W.depthwise_conv1d)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,k", [((2, 300, 256), 31), ((3, 77, 40), 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_backward_matches_plain_autograd(cuda, shape, k, dtype):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype).requires_grad_()
    w = (torch.randn((k, shape[2]), generator=gen, device=cuda) * 0.1).to(dtype).requires_grad_()
    g = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    counts = (W.depthwise_conv1d.launches, W.depthwise_conv1d_dx.launches,
              W.depthwise_conv1d_dw.launches)
    y = W.depthwise_conv1d(x, w)
    assert y.grad_fn is not None
    dx, dw = torch.autograd.grad(y, (x, w), g)
    torch.cuda.synchronize()
    assert (W.depthwise_conv1d.launches, W.depthwise_conv1d_dx.launches,
            W.depthwise_conv1d_dw.launches) == tuple(c + 1 for c in counts)
    want_dx, want_dw = torch.autograd.grad(W.depthwise_conv1d_plain(x, w), (x, w), g)
    assert dx.dtype == dw.dtype == dtype
    _assert_close(dx, want_dx, 1e-4, "dx")
    _assert_close(dw, want_dw, 1e-4, "dw")
    # no atomics: a second run gives the same bits
    assert torch.equal(torch.autograd.grad(W.depthwise_conv1d(x, w), w, g)[0], dw)


def _attention_inputs(B, H, T, D, dtype, device, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, T, H, D)).astype(np.float32))
                   .to(device, dtype).transpose(1, 2) for _ in range(4))
    mask = torch.ones((B, T), dtype=torch.bool)
    mask[0, T * 2 // 3:] = False   # a padded tail
    mask[-1] = False               # a batch-padding row: no real key
    return q, k, v, do, mask.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,D", [(3, 2, 130, 64), (2, 4, 200, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_matches_plain_autograd(cuda, B, H, T, D, dtype):
    q, k, v, do, mask = _attention_inputs(B, H, T, D, dtype, cuda, seed=T)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    scale = D ** -0.5
    before = (A.flash_attention_fwd_res.launches, A.flash_attention_bwd_dkv.launches,
              A.flash_attention_bwd_dq.launches, A.flash_attention.launches)
    out = A.flash_attention(q, k, v, mask, scale)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (A.flash_attention_fwd_res.launches, A.flash_attention_bwd_dkv.launches,
            A.flash_attention_bwd_dq.launches, A.flash_attention.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1, before[3])
    want_out = A.attention_plain(q, k, v, mask, scale)
    wants = torch.autograd.grad(want_out, (q, k, v), do)
    _assert_close(out, want_out, 0.02 if dtype == torch.bfloat16 else 2e-5, "out")
    for name, got, want in zip("qkv", grads, wants):
        _assert_close(got, want, 0.02 if dtype == torch.bfloat16 else 2e-5, f"d{name}")
    empty = ~mask.any(dim=1)
    # the batch-padding row: dq and dk exactly 0, dv = P^T dO with P uniform
    assert torch.equal(grads[0][empty], torch.zeros_like(grads[0][empty]))
    assert torch.equal(grads[1][empty], torch.zeros_like(grads[1][empty]))
    assert grads[2][empty].abs().sum() > 0
    # padded keys of a real row carry no gradient either
    assert torch.equal(grads[1][0, :, T * 2 // 3:], torch.zeros_like(grads[1][0, :, T * 2 // 3:]))
    # no atomics: a second run gives the same bits
    again = torch.autograd.grad(A.flash_attention(q, k, v, mask, scale), (q, k, v), do)
    assert all(torch.equal(a, b) for a, b in zip(again, grads))
