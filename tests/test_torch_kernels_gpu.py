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

from chip_smoke import fused_ffn_tolerance, grad_tolerance, splash_forward_tolerance
from some_tpu_torch.ops import attention as A
from some_tpu_torch.ops import depthwise as W
from some_tpu_torch.ops import fused_ffn as K3


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
    qd = q.detach()
    with pytest.raises(RuntimeError, match="no backward"):
        A._splash_forward(q, qd, qd, None, A.splash_attention)
    with pytest.raises(RuntimeError, match="no backward"):
        A.splash_attention_fwd_res(q, qd, qd, None)
    lse = torch.zeros(1, 2, 8)
    for bwd in (A.splash_attention_bwd_dkv, A.splash_attention_bwd_dq):
        with pytest.raises(RuntimeError, match="no backward"):
            bwd(q, qd, qd, qd, lse, lse, None)
    h = torch.randn(1, 8, 64, requires_grad=True)
    vecs = [torch.ones(64), torch.zeros(64), torch.zeros(64, 256), torch.zeros(256),
            torch.zeros(256, 64), torch.zeros(64)]
    with pytest.raises(RuntimeError, match="no backward"):
        K3._launch(h, *vecs, 1e-5, 0.5)
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


# (B, H, T, D): ragged T (not a multiple of the 64-key tile, and one long
# enough for many tiles) at both head dims, and a head stride of 4 heads;
# _attention_inputs adds a padded tail and an all-masked row
GRID = [(3, 2, T, D) for T in (77, 130, 200, 1000) for D in (32, 64)] + [(2, 4, 200, 32)]
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = pytest.mark.parametrize("D", [32, 64])

# At two points of the grid the bf16 K2 dk/dv kernel misses the 0.02 RMS
# bound on dk against the plain autograd, with the tensor-core training
# forward and with the CUDA-core one it replaced alike: a fault of the
# backward against its bound (ROADMAP.md queue 3). Strict, so the suite
# fails once the kernel meets it.
K2_DK_GAP = pytest.mark.xfail(strict=True, raises=AssertionError,
                              reason="bf16 K2 dk misses its 0.02 RMS bound (ROADMAP.md queue 3)")
K2_BACKWARD = [pytest.param(*point, dtype, id="-".join(map(str, point)) + f"-{str(dtype)[6:]}",
                            marks=K2_DK_GAP if dtype == torch.bfloat16
                            and point in ((3, 2, 77, 64), (3, 2, 200, 64)) else ())
               for point in GRID for dtype in DTYPES]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,D,dtype", K2_BACKWARD)
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


@pytest.mark.gpu
@pytest.mark.parametrize("shape,D,H", [((2, 300), 512, 2048), ((3, 77), 64, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ffn_matches_plain(cuda, shape, D, H, dtype):
    gen = torch.Generator(device=cuda).manual_seed(5)
    randn = lambda *s: torch.randn(s, generator=gen, device=cuda)
    weights = [1.0 + 0.1 * randn(D), 0.1 * randn(D), randn(D, H) * D ** -0.5, 0.1 * randn(H),
               randn(H, D) * H ** -0.5, 0.1 * randn(D)]
    x = randn(*shape, D).to(dtype)
    before = K3.fused_ln_ffn_residual.launches
    got = K3.fused_ln_ffn_residual(x, *weights)
    torch.cuda.synchronize()
    assert K3.fused_ln_ffn_residual.launches == before + 1
    want = K3.fused_ln_ffn_residual(x, *weights, impl="plain")
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert ((got.float() - want.float()).abs() <= fused_ffn_tolerance(torch, want)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,D", GRID)
@pytest.mark.parametrize("dtype", DTYPES)
def test_splash_matches_plain_forward_and_autograd(cuda, B, H, T, D, dtype):
    q, k, v, do, mask = _attention_inputs(B, H, T, D, dtype, cuda, seed=T + 1)
    scale = D ** -0.5
    with torch.no_grad():
        before = A.splash_attention.launches
        got = A.splash_attention(q, k, v, mask, scale)
        assert A.splash_attention.launches == before + 1
        want = A.splash_attention_plain(q, k, v, mask, scale)
        assert ((got.float() - want.float()).abs() <= splash_forward_tolerance(torch, want)).all()
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    before = (A.splash_attention_fwd_res.launches, A.splash_attention_bwd_dkv.launches,
              A.splash_attention_bwd_dq.launches, A.splash_attention.launches)
    out = A.splash_attention(q, k, v, mask, scale)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert (A.splash_attention_fwd_res.launches, A.splash_attention_bwd_dkv.launches,
            A.splash_attention_bwd_dq.launches, A.splash_attention.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1, before[3])
    assert torch.equal(out, got)
    wants = torch.autograd.grad(A.splash_attention_plain(q, k, v, mask, scale), (q, k, v), do)
    for name, g, w in zip("qkv", grads, wants):
        _assert_close(g, w, 0.1 if dtype == torch.bfloat16 else 5e-5, f"d{name}")
    # with dO zero on the padded queries no gradient reaches a padded frame
    zeroed = torch.autograd.grad(A.splash_attention(q, k, v, mask, scale), (q, k, v),
                                 do * mask[:, None, :, None])
    for g in zeroed:
        assert torch.equal(g.transpose(1, 2)[~mask], torch.zeros_like(g.transpose(1, 2)[~mask]))
    again = torch.autograd.grad(A.splash_attention(q, k, v, mask, scale), (q, k, v), do)
    assert all(torch.equal(a, b) for a, b in zip(again, grads))


def _cut_inputs(D, device, real=128, T=200):
    """bf16 q, k, v as [B, H, T, D] views of [B, T, H, D] storage, row 0 real
    up to ``real`` (a multiple of the 64-key tile) and padded after it, row 1
    ragged."""
    q, k, v, _, _ = _attention_inputs(2, 2, T, D, torch.bfloat16, device, seed=D)
    mask = torch.ones((2, T), dtype=torch.bool, device=device)
    mask[0, real:] = False
    mask[1, T - 5:] = False
    return q, k, v, mask


@pytest.mark.gpu
@HEAD_DIMS
def test_flash_fwd_res_skips_masked_tiles_bit_for_bit(cuda, D):
    """The key tiles past row 0's real length hold only masked keys, so the
    bf16 training forward skips them for row 0's queries: its real rows equal,
    bit for bit, the same call on the inputs cut at that length."""
    q, k, v, mask = _cut_inputs(D, cuda)
    L = 128
    before = A.flash_attention_fwd_res.launches
    out, stats = A.flash_attention_fwd_res(q, k, v, mask, D ** -0.5)
    cut_out, cut_stats = A.flash_attention_fwd_res(q[:, :, :L], k[:, :, :L], v[:, :, :L],
                                                   mask[:, :L].contiguous(), D ** -0.5)
    torch.cuda.synchronize()
    assert A.flash_attention_fwd_res.launches == before + 2
    assert torch.equal(out[0, :, :L], cut_out[0])
    assert torch.equal(stats[0, :, :L], cut_stats[0])


@pytest.mark.gpu
@HEAD_DIMS
def test_splash_fwd_skips_other_segment_tiles_bit_for_bit(cuda, D):
    """The key tiles past row 0's real length hold only padding keys, which
    no real query attends: the bf16 splash forward skips them for the real
    queries, whose outputs and log-sum-exps equal, bit for bit, the same call
    on the inputs cut at that length; with and without lse alike."""
    q, k, v, mask = _cut_inputs(D, cuda)
    L = 128
    qs = A.prescale(q, D ** -0.5)
    out, lse = A.splash_attention_fwd_res(qs, k, v, mask)
    cut_out, cut_lse = A.splash_attention_fwd_res(qs[:, :, :L], k[:, :, :L], v[:, :, :L],
                                                  mask[:, :L].contiguous())
    with torch.no_grad():
        inference = A.splash_attention(q, k, v, mask, D ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(out[0, :, :L], cut_out[0])
    assert torch.equal(lse[0, :, :L], cut_lse[0])
    assert torch.equal(inference, out)


@pytest.mark.gpu
@HEAD_DIMS
def test_splash_fwd_keeps_p_f32(cuda, D):
    """P stays f32 in P.V (hi + lo, two bf16 products), so with v = 1 every
    output, sum(p) / l, is 1 to about 2^-16: exactly 1 in bf16. P cut to bf16
    (hi alone) loses about 2^-9 of the sum, which rounds below 1; the last
    lines show that on the same scores, so this test would see it."""
    B, H, T = 3, 2, 200
    q, k, _, _, mask = _attention_inputs(B, H, T, D, torch.bfloat16, cuda, seed=D + 2)
    v = torch.ones((B, T, H, D), dtype=torch.bfloat16, device=cuda).transpose(1, 2)
    qs = A.prescale(q, D ** -0.5)
    with torch.no_grad():
        out = A.splash_attention(q, k, v, mask, D ** -0.5)
    out_res, _ = A.splash_attention_fwd_res(qs, k, v, mask)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.ones_like(out))
    assert torch.equal(out_res, out)
    same = (mask[:, :, None] == mask[:, None, :])[:, None]
    s = (qs.float() @ k.float().transpose(-1, -2)).masked_fill(~same, A.SPLASH_MASK_VALUE)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    hi = (p.view(torch.int32) & -65536).view(torch.float32)
    cut = (hi.sum(-1) / p.sum(-1)).to(torch.bfloat16)
    assert float((cut < 1).float().mean()) > 0.5


def _kernel_names(fn):
    """The names of the CUDA kernels that ``fn()`` launches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_kernels_route_by_dtype(cuda, dtype):
    """bf16 inputs reach the tensor-core kernels and nothing else; f32 inputs
    the CUDA-core kernels (true f32)."""
    q, k, v, _, mask = _attention_inputs(2, 2, 130, 64, dtype, cuda, seed=9)
    bf16 = dtype == torch.bfloat16
    counts = A.flash_attention_fwd_res.launches, A.splash_attention_fwd_res.launches
    flash = [n for n in _kernel_names(lambda: A.flash_attention_fwd_res(q, k, v, mask, 0.125))
             if "flash_fwd" in n]
    splash = [n for n in _kernel_names(lambda: A.splash_attention_fwd_res(q, k, v, mask))
              if "splash_fwd" in n]
    assert (A.flash_attention_fwd_res.launches, A.splash_attention_fwd_res.launches) == (
        counts[0] + 1, counts[1] + 1)
    assert len(flash) == 1 and len(splash) == 1, (flash, splash)
    assert ("flash_fwd_stats_mma_kernel" in flash[0]) == bf16, flash
    assert "flash_fwd_stats" in flash[0], flash
    assert ("splash_fwd_mma_kernel" in splash[0]) == bf16, splash


def test_bf16_forward_refuses_misaligned_rows():
    """cp.async copies 16-byte rows: a bf16 pointer or stride off that grid
    raises before any launch, with no fallback to another kernel."""
    storage = torch.zeros(2 * 2 * 16 * 32 + 1, dtype=torch.bfloat16)
    shifted = storage[1:].view(2, 2, 16, 32)   # 2 bytes off a 16-byte boundary
    wide = torch.zeros(2, 2, 16, 36, dtype=torch.bfloat16)[..., :32]  # 72-byte time stride
    ok = torch.zeros(2, 2, 16, 32, dtype=torch.bfloat16)
    for bad in (shifted, wide):
        with pytest.raises(ValueError, match="16-byte"):
            A.flash_attention_fwd_res(bad, ok, ok, None, 0.1)
        with pytest.raises(ValueError, match="16-byte"):
            A.splash_attention_fwd_res(ok, ok, bad, None)
        with torch.no_grad(), pytest.raises(ValueError, match="16-byte"):
            A._splash_forward(ok, bad, ok, None, A.splash_attention)
