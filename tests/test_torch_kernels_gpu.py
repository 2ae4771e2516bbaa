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

from chip_smoke import (
    BF16_PLAIN_HELD, fused_ffn_tolerance, grad_tolerance, splash_f32_reference,
    splash_flip_allowance, splash_forward_tolerance, variants_launched,
)
from test_torch_depthwise import at_odd_offset

from some_tpu_torch.ops import attention as A
from some_tpu_torch.ops import depthwise as W
from some_tpu_torch.ops import fused_ffn as K3
from some_tpu_torch.ops import quant


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
@pytest.mark.parametrize("shape,k,offset", [
    ((2, 300, 256), 31, False), ((3, 77, 40), 7, False),
    # the main paths' shapes
    ((8, 512, 512), 31, False), ((1, 6144, 512), 31, False), ((8, 2048, 512), 31, False),
    # ragged C and T
    ((2, 1, 300), 31, False), ((1, 37, 520), 31, False), ((2, 1000, 5), 7, False),
    ((1, 77, 300), 31, False),
    # x and g at an odd element offset
    ((2, 300, 512), 31, True), ((1, 1000, 520), 7, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_backward_matches_plain_autograd(cuda, shape, k, offset, dtype):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    w = (torch.randn((k, shape[2]), generator=gen, device=cuda) * 0.1).to(dtype).requires_grad_()
    g = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    if offset:
        x, g = at_odd_offset(x), at_odd_offset(g)
    x.requires_grad_()
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

K2_BACKWARD = [pytest.param(*point, dtype, id="-".join(map(str, point)) + f"-{str(dtype)[6:]}")
               for point in GRID for dtype in DTYPES]


def _ratio(got, want, rel, extra=0.0):
    """max |got - want| / (grad_tolerance(want, rel) + extra)."""
    tol = grad_tolerance(torch, want, rel, got.dtype) + extra
    return float(((got.float() - want.float()).abs() / tol).max())


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,D,dtype", K2_BACKWARD)
def test_attention_backward_matches_plain_autograd(cuda, B, H, T, D, dtype):
    """In bf16 the kernels' out, dq, dk and dv are held against the f32
    gradient of the same bf16 inputs (the autograd of the plain version on
    q, k, v, dO cast to f32), and all but dk against the plain bf16 autograd
    too (BF16_PLAIN_HELD): that autograd rounds dP = dO V^T to bf16 before
    dS = P (dP - delta) cancels, where the kernels keep dP in f32 as JAX's
    kernel does, and misses the f32 gradient's bound on dk itself. Both
    bounds are 2 ulp of |want| + 0.02 RMS(want)."""
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
    assert all(torch.isfinite(t.float()).all() for t in (out, *grads))
    want_out = A.attention_plain(q, k, v, mask, scale)
    wants = torch.autograd.grad(want_out, (q, k, v), do)
    bf16 = dtype == torch.bfloat16
    rel = 0.02 if bf16 else 2e-5
    ratios = {"plain": [_ratio(out, want_out, rel)]
              + [_ratio(g, w, rel) for g, w in zip(grads, wants)]}
    names = ("out", "dq", "dk", "dv")
    held = {"plain": names if not bf16 else BF16_PLAIN_HELD}
    if bf16:
        leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
        want32 = A.attention_plain(*leaves, mask, scale)
        wants32 = torch.autograd.grad(want32, leaves, do.float())
        ratios["f32"] = [_ratio(out, want32, rel)] + [_ratio(g, w, rel)
                                                     for g, w in zip(grads, wants32)]
        ratios["plain bf16 vs f32"] = [_ratio(want_out, want32, rel)] + [
            _ratio(w, w32, rel) for w, w32 in zip(wants, wants32)]
        held["f32"] = names
    print(f"K2 backward {(B, H, T, D)} {str(dtype)[6:]} |d|/tol (out, dq, dk, dv): "
          + "; ".join(f"{ref} {[round(r, 4) for r in rs]}" for ref, rs in ratios.items()))
    for ref, which in held.items():
        for name in which:
            assert ratios[ref][names.index(name)] <= 1.0, (ref, name, ratios[ref])
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
@pytest.mark.parametrize("T,D", [(77, 64), (200, 64), (77, 32)])
def test_bf16_backward_meets_the_f32_bound_over_many_draws(cuda, T, D):
    """One draw of the grid shows little of a tail: dq once passed every grid
    point and missed on chip_smoke's own draw at (3, 2, 77, 64). Here 300
    draws a shape, made as chip_smoke makes them (a CUDA generator, [B, T, H,
    D] storage, keys from 0.7 T masked in row 0, row 2 all masked), hold the
    bf16 dq and dk within 2 ulp + 0.02 RMS of the f32 gradient of the same
    bf16 inputs, and out and dv within the same bound of the plain bf16
    autograd: those two take round(P), the P the forward multiplied with V,
    as that autograd and JAX's kernel do, and that rounding alone takes dv
    past the f32 bound on some draws, the plain bf16 autograd's with it.
    Prints the largest |d|/tol against f32 of the kernels' and of the plain
    bf16 autograd's results, and how many draws pass 1."""
    B, H, scale, draws = 3, 2, D ** -0.5, 300
    names = ("out", "dq", "dk", "dv")
    kernel, plain, vs_plain = (torch.zeros(draws, 4) for _ in range(3))
    for i in range(draws):
        gen = torch.Generator(device=cuda).manual_seed(i)
        q, k, v, do = (torch.randn((B, T, H, D), generator=gen, device=cuda)
                       .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
        mask = torch.ones((B, T), dtype=torch.bool, device=cuda)
        mask[0, int(T * 0.7):] = False
        mask[B - 1] = False
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        results = []
        for fn in (A.flash_attention, A.attention_plain):
            out = fn(*leaves, mask, scale)
            results.append((out, *torch.autograd.grad(out, leaves, do)))
        leaves32 = [t.detach().float().requires_grad_() for t in leaves]
        want32 = A.attention_plain(*leaves32, mask, scale)
        wants = (want32, *torch.autograd.grad(want32, leaves32, do.float()))
        for row, got in zip((kernel, plain), results):
            row[i] = torch.tensor([_ratio(g, w, 0.02) for g, w in zip(got, wants)])
        vs_plain[i] = torch.tensor([_ratio(g, w, 0.02) for g, w in zip(*results)])
    print(f"K2 bf16 backward (3, 2, {T}, {D}) vs f32 over {draws} draws: " + "; ".join(
        f"{n} kernel max {kernel[:, j].max():.4f} ({int((kernel[:, j] > 1).sum())} past 1), "
        f"plain bf16 max {plain[:, j].max():.4f} ({int((plain[:, j] > 1).sum())} past 1)"
        for j, n in enumerate(names)))
    print(f"  kernel vs plain bf16: out max {vs_plain[:, 0].max():.4f}, "
          f"dv max {vs_plain[:, 3].max():.4f}")
    held = torch.stack([vs_plain[:, 0], kernel[:, 1], kernel[:, 2], vs_plain[:, 3]], dim=1)
    assert float(held.max()) <= 1.0, {n: float(held[:, j].max()) for j, n in enumerate(names)}


@pytest.mark.gpu
@pytest.mark.parametrize("T,D", [(77, 64), (200, 64), (77, 32)])
def test_splash_bf16_backward_meets_the_f32_bound_over_many_draws(cuda, T, D):
    """K4's bf16 dqs (the gradient of the pre-scaled q), dk and dv, from the
    training forward's residuals and the backward as SplashAttentionFn runs
    it, over 300 draws a shape made as the K2 test above makes them (row 0
    padded from 0.7 T, the last row all padding), within 2 ulp + 0.02 RMS of
    chip_smoke's splash_f32_reference: splash's function in f32 on the bf16
    inputs, with its roundings of P and dS to bf16 kept and di = rowsum(P dP)
    in f32. The bound allows for f32 sums in another order and the P or dS
    that lands on the other side of a bf16 rounding. Prints the largest
    |d|/tol and the draws past 1 against that reference, against the
    unrounded f32 gradient and against the plain bf16 autograd; only the
    first is held."""
    B, H, draws = 3, 2, 300
    names, refs = ("dq", "dk", "dv"), ("f32 reference", "unrounded f32", "plain bf16")
    ratios = {ref: torch.zeros(draws, 3) for ref in refs}
    for i in range(draws):
        gen = torch.Generator(device=cuda).manual_seed(i)
        q, k, v, do = (torch.randn((B, T, H, D), generator=gen, device=cuda)
                       .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
        mask = torch.ones((B, T), dtype=torch.bool, device=cuda)
        mask[0, int(T * 0.7):] = False
        mask[B - 1] = False
        qs = A.prescale(q, D ** -0.5)
        out, lse, out_lo = A.splash_attention_fwd_res(qs, k, v, mask)
        got = A.splash_attention_backward(qs, k, v, out, out_lo, do, lse, mask)
        wants = {"f32 reference": splash_f32_reference(torch, qs, k, v, do, mask)}
        for ref, dtype in (("unrounded f32", torch.float32), ("plain bf16", torch.bfloat16)):
            leaves = [t.detach().to(dtype).requires_grad_() for t in (qs, k, v)]
            wants[ref] = torch.autograd.grad(A.splash_attention_plain(*leaves, mask, 1.0),
                                             leaves, do.to(dtype))
        for ref in refs:
            ratios[ref][i] = torch.tensor([_ratio(g, w, 0.02) for g, w in zip(got, wants[ref])])
    print(f"K4 bf16 backward (3, 2, {T}, {D}) over {draws} draws, max |d|/tol (draws past 1): "
          + "; ".join(ref + " " + ", ".join(
              f"{n} {r[:, j].max():.4f} ({int((r[:, j] > 1).sum())})"
              for j, n in enumerate(names)) for ref, r in ratios.items()))
    held = ratios["f32 reference"]
    assert float(held.max()) <= 1.0, {n: float(held[:, j].max()) for j, n in enumerate(names)}


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,D,dtype", K2_BACKWARD)
def test_dq_kernel_returns_the_rowsum_of_p_dp(cuda, B, H, T, D, dtype):
    """The dq kernel's second output is delta = rowsum(P dP) over the real
    keys, in f32, whatever delta it was given: here rowsum(dO * O) with the
    forward's O, and the same plus 1 in the all-masked row, which has no real
    key and keeps what it was given. Against the rowsum in f64 of the plain
    P and dP: within 1e-5 of that rowsum's RMS (f32 sums over T keys)."""
    q, k, v, do, mask = _attention_inputs(B, H, T, D, dtype, cuda, seed=T + 5)
    scale = D ** -0.5
    out, stats = A.flash_attention_fwd_res(q, k, v, mask, scale)
    given = (do.float() * out.float()).sum(-1)
    empty = ~mask.any(dim=1)
    given[empty] += 1.0
    _, delta = A.flash_attention_bwd_dq(q, k, v, do, stats, given.contiguous(), mask, scale)
    torch.cuda.synchronize()
    s = (q.double() @ k.double().transpose(-1, -2)) * scale
    p = torch.softmax(s.masked_fill(~mask[:, None, None, :], float("-inf")), dim=-1)
    want = (p * (do.double() @ v.double().transpose(-1, -2))).sum(-1)
    real = ~empty
    err = float((delta[real].double() - want[real]).abs().max())
    print(f"K2 dq's delta {(B, H, T, D)} {str(dtype)[6:]}: max |d| / RMS "
          f"{err / float(want[real].pow(2).mean().sqrt()):.3g}")
    assert err <= 1e-5 * float(want[real].pow(2).mean().sqrt())
    assert torch.equal(delta[empty], given[empty])


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,D,dtype", K2_BACKWARD)
def test_dkv_kernel_matches_its_plain_version(cuda, B, H, T, D, dtype):
    """The dk/dv kernel against flash_attention_bwd_dkv_plain, which rounds
    where the kernel rounds (round(P) for dV, dS * scale as hi + lo before
    dK), on the training forward's statistics: 2 ulp of |want| + 0.002
    RMS(want) in bf16, ten times tighter than the bound against the
    autograd. What is left is f32 sums in another order, exp on the
    special-function unit (about 2 f32 ulp), and the rare P that lands on
    the other side of a bf16 rounding (one ulp of one term of a sum over T
    queries). f32: 2e-5 RMS."""
    q, k, v, do, mask = _attention_inputs(B, H, T, D, dtype, cuda, seed=T + 3)
    scale = D ** -0.5
    out, stats = A.flash_attention_fwd_res(q, k, v, mask, scale)
    delta = (do.float() * out.float()).sum(-1).contiguous()
    got = A.flash_attention_bwd_dkv(q, k, v, do, stats, delta, mask, scale)
    want = A.flash_attention_bwd_dkv_plain(q, k, v, do, stats, delta, mask, scale)
    torch.cuda.synchronize()
    rel = 0.002 if dtype == torch.bfloat16 else 2e-5
    ratios = [_ratio(g, w, rel) for g, w in zip(got, want)]
    print(f"K2 dk/dv kernel vs plain {(B, H, T, D)} {str(dtype)[6:]} |d|/tol (dk, dv): {ratios}")
    assert max(ratios) <= 1.0, ratios


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,D,dtype", K2_BACKWARD)
def test_dq_kernel_matches_its_plain_version(cuda, B, H, T, D, dtype):
    """The dq kernel against flash_attention_bwd_dq_plain, which rounds where
    the kernel rounds (dS * scale as hi + lo, round(P) in the correction
    sum P K), on the training forward's statistics and the caller's delta:
    dq within 2 ulp + 0.002 RMS in bf16 and 2e-5 RMS in f32, as the dk/dv
    kernel; its corrected delta within 1e-5 of its RMS (f32 sums in another
    order). A second run gives the same bits (no atomics)."""
    q, k, v, do, mask = _attention_inputs(B, H, T, D, dtype, cuda, seed=T + 11)
    scale = D ** -0.5
    out, stats = A.flash_attention_fwd_res(q, k, v, mask, scale)
    delta = (do.float() * out.float()).sum(-1).contiguous()
    dq, delta_out = A.flash_attention_bwd_dq(q, k, v, do, stats, delta, mask, scale)
    want, want_delta = A.flash_attention_bwd_dq_plain(q, k, v, do, stats, delta, mask, scale)
    again = A.flash_attention_bwd_dq(q, k, v, do, stats, delta, mask, scale)
    torch.cuda.synchronize()
    ratio = _ratio(dq, want, 0.002 if dtype == torch.bfloat16 else 2e-5)
    delta_err = float((delta_out - want_delta).abs().max() / want_delta.pow(2).mean().sqrt())
    print(f"K2 dq kernel vs plain {(B, H, T, D)} {str(dtype)[6:]}: dq |d|/tol {ratio:.4f}, "
          f"delta max |d| / RMS {delta_err:.3g}")
    assert ratio <= 1.0 and delta_err <= 1e-5, (ratio, delta_err)
    assert torch.equal(again[0], dq) and torch.equal(again[1], delta_out)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,T,D,dtype", K2_BACKWARD)
def test_splash_backward_kernels_match_their_plain_versions(cuda, B, H, T, D, dtype):
    """K4's backward on the training forward's residuals: di from the output
    and its bf16 rounding residual (splash_di) is rowsum(P dP) within 1e-4
    of its RMS against f64 (from the bf16 output alone it is about 2e-3
    off, printed); the dq and dk/dv kernels on that di against
    splash_attention_bwd_dq_plain and splash_attention_bwd_dkv_plain, which
    round P and dS where splash rounds them: 2 ulp + 0.002 RMS in bf16,
    2e-5 RMS in f32. The bf16 dq, dk and dv may also differ by one rounding
    flip of a dS or a P (chip_smoke's splash_flip_allowance): without it dk
    read 2.2356 and the tensor-core dq 2.2209 at (3, 2, 1000, 32) on an
    H100. A second run of dk/dv gives the same bits."""
    q, k, v, do, mask = _attention_inputs(B, H, T, D, dtype, cuda, seed=T + 13)
    qs = A.prescale(q, D ** -0.5)
    out, lse, out_lo = A.splash_attention_fwd_res(qs, k, v, mask)
    assert (out_lo is None) == (dtype == torch.float32)
    di = A.splash_di(out, out_lo, do)
    dq = A.splash_attention_bwd_dq(qs, k, v, do, lse, di, mask)
    dkv = A.splash_attention_bwd_dkv(qs, k, v, do, lse, di, mask)
    again = A.splash_attention_bwd_dkv(qs, k, v, do, lse, di, mask)
    torch.cuda.synchronize()
    s = (qs.double() @ k.double().transpose(-1, -2)).masked_fill(~A._segment_mask(mask),
                                                                 float("-inf"))
    want_di = (torch.softmax(s, dim=-1) * (do.double() @ v.double().transpose(-1, -2))).sum(-1)
    rms_di = want_di.pow(2).mean().sqrt()
    di_err = float((di.double() - want_di).abs().max() / rms_di)
    rounded_err = float((A.splash_di(out, None, do).double() - want_di).abs().max() / rms_di)
    bf16 = dtype == torch.bfloat16
    rel = 0.002 if bf16 else 2e-5
    flips = splash_flip_allowance(torch, qs, k, v, do, lse, di, mask) if bf16 else (
        0.0, 0.0, 0.0)
    wants = (A.splash_attention_bwd_dq_plain(qs, k, v, do, lse, di, mask),
             *A.splash_attention_bwd_dkv_plain(qs, k, v, do, lse, di, mask))
    ratios = [_ratio(g, w, rel, extra) for g, w, extra in zip((dq, *dkv), wants, flips)]
    print(f"K4 backward kernels vs plain {(B, H, T, D)} {str(dtype)[6:]}: di max |d| / RMS "
          f"{di_err:.3g} (from the output alone {rounded_err:.3g}); |d|/tol (dq, dk, dv) "
          f"{[f'{r:.3g}' for r in ratios]}, without the flip allowance "
          f"{[f'{_ratio(g, w, rel):.3g}' for g, w in zip((dq, *dkv), wants)]}")
    assert di_err <= 1e-4 and max(ratios) <= 1.0, (di_err, ratios)
    assert all(torch.equal(a, b) for a, b in zip(again, dkv))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 300), (3, 77), (1, 1), (1, 63), (1, 65), (1, 6144)])
@pytest.mark.parametrize("D,H", K3.WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ffn_matches_plain(cuda, shape, D, H, dtype):
    """Row counts below, at and past the bf16 kernel's 64-row block (and
    the f32 kernel's 32), ragged and long, at both built widths, within
    chip_smoke's fused_ffn_tolerance."""
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
    assert got.dtype == dtype and got.shape == x.shape and torch.isfinite(got.float()).all()
    ratio = float(((got.float() - want.float()).abs() / fused_ffn_tolerance(torch, want)).max())
    print(f"K3 {list(x.shape)} {str(dtype)[6:]}: max |d|/tol {ratio:.4f}")
    assert ratio <= 1.0, ratio


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
def test_flash_inference_and_dkv_skip_masked_tiles_bit_for_bit(cuda, D):
    """Row 0's real keys end at a 64-key tile edge. The bf16 inference forward
    skips the masked key tiles after it for row 0's queries, and the dk/dv
    kernel's blocks of those keys write dk = dv = 0 and return: row 0's real
    rows of the output, and of dk and dv, equal bit for bit the same calls on
    the inputs cut at that length. dO is 0 at row 0's padded queries, so in
    the full call they add exact zeros to the real keys' dk and dv."""
    q, k, v, mask = _cut_inputs(D, cuda)
    L, scale = 128, D ** -0.5
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(D),
                     device=cuda).to(torch.bfloat16).transpose(1, 2).contiguous().transpose(1, 2)
    do[0, :, L:] = 0
    cut = lambda t: t[:, :, :L]
    calls = {}
    for name, args in (("full", (q, k, v, do, mask)),
                       ("cut", (cut(q), cut(k), cut(v), cut(do), mask[:, :L].contiguous()))):
        with torch.no_grad():
            inference = A.flash_attention(*args[:3], args[4], scale)
        out, stats = A.flash_attention_fwd_res(*args[:3], args[4], scale)
        delta = (args[3].float() * out.float()).sum(-1).contiguous()
        calls[name] = (inference, *A.flash_attention_bwd_dkv(*args[:4], stats, delta, args[4],
                                                             scale))
    torch.cuda.synchronize()
    for full, short in zip(calls["full"], calls["cut"]):
        assert torch.equal(full[0, :, :L], short[0])
    for grad in calls["full"][1:]:
        assert not grad[0, :, L:].any()


@pytest.mark.gpu
@HEAD_DIMS
def test_dq_and_splash_dkv_skip_tiles_bit_for_bit(cuda, D):
    """Row 0's real frames end at a 64-frame tile edge. The bf16 K2 dq kernel
    walks only key tiles with a real key, so row 0's dq and corrected delta
    equal, on every query row of the cut length, the same call on the inputs
    cut there. The bf16 K4 dk/dv kernel walks only query tiles with a query
    of a segment its keys have, so row 0's real keys get dk and dv equal to
    the cut call's (lse and di as the full call's forward and dq kernel gave
    them, cut). The bf16 K4 dq kernel walks only key tiles with a key of a
    segment its queries have, so row 0's dq equals the cut call's on every
    query row of the cut length."""
    q, k, v, mask = _cut_inputs(D, cuda)
    L, scale = 128, D ** -0.5
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(D + 1),
                     device=cuda).to(torch.bfloat16).transpose(1, 2).contiguous().transpose(1, 2)
    cut = lambda t: t[:, :, :L]
    mask_cut = mask[:, :L].contiguous()
    out, stats = A.flash_attention_fwd_res(q, k, v, mask, scale)
    delta = (do.float() * out.float()).sum(-1).contiguous()
    full = A.flash_attention_bwd_dq(q, k, v, do, stats, delta, mask, scale)
    short = A.flash_attention_bwd_dq(cut(q), cut(k), cut(v), cut(do), cut(stats).contiguous(),
                                     cut(delta).contiguous(), mask_cut, scale)
    qs = A.prescale(q, scale)
    out, lse, out_lo = A.splash_attention_fwd_res(qs, k, v, mask)
    di = A.splash_di(out, out_lo, do)
    splash_full = A.splash_attention_bwd_dkv(qs, k, v, do, lse, di, mask)
    splash_short = A.splash_attention_bwd_dkv(cut(qs), cut(k), cut(v), cut(do),
                                              cut(lse).contiguous(), cut(di).contiguous(),
                                              mask_cut)
    splash_full += (A.splash_attention_bwd_dq(qs, k, v, do, lse, di, mask),)
    splash_short += (A.splash_attention_bwd_dq(cut(qs), cut(k), cut(v), cut(do),
                                               cut(lse).contiguous(), cut(di).contiguous(),
                                               mask_cut),)
    torch.cuda.synchronize()
    for a, b in zip(full, short):
        assert torch.equal(a[0, :, :L], b[0])
    for a, b in zip(splash_full, splash_short):
        assert a[0, :, :L].abs().sum() > 0 and torch.equal(a[0, :, :L], b[0])


@pytest.mark.gpu
@pytest.mark.parametrize("T,D", [(64, 64), (50, 64), (32, 32)])
def test_dkv_rebuilds_the_forwards_p_bit_for_bit(cuda, T, D):
    """With V the identity the bf16 training forward's output is the P it
    multiplied with V: out[q, j] = round(P[q, j]) for j < T. With dO the
    identity the dk/dv kernel's dV is the P it rebuilt: dV[j, q] =
    round(P[q, j]). The two must agree bit for bit, on real keys, masked keys
    (P = 0) and the all-masked row (P uniform): both kernels sum Q K^T on the
    tensor cores over the same k16 steps and take exp(score - m) * (1 / l)
    with the same arithmetic."""
    B, H = 3, 2
    q, k, _, _, mask = _attention_inputs(B, H, T, D, torch.bfloat16, cuda, seed=T + D)
    mask[0] = True
    mask[0, T * 4 // 5:] = False
    eye = torch.eye(T, D, dtype=torch.bfloat16, device=cuda).expand(B, H, T, D).contiguous()
    out, stats = A.flash_attention_fwd_res(q, k, eye, mask, D ** -0.5)
    delta = torch.zeros((B, H, T), dtype=torch.float32, device=cuda)
    _, dv = A.flash_attention_bwd_dkv(q, k, eye, eye, stats, delta, mask, D ** -0.5)
    torch.cuda.synchronize()
    p_forward = out[..., :T]
    p_backward = dv[..., :T].transpose(-1, -2)
    assert p_forward.abs().sum() > 0 and torch.equal(p_backward, p_forward)
    assert not p_forward[0, :, :, T * 4 // 5:].any()   # masked keys of a real row


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
    out, lse, lo = A.splash_attention_fwd_res(qs, k, v, mask)
    cut_out, cut_lse, cut_lo = A.splash_attention_fwd_res(qs[:, :, :L], k[:, :, :L],
                                                          v[:, :, :L], mask[:, :L].contiguous())
    with torch.no_grad():
        inference = A.splash_attention(q, k, v, mask, D ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(out[0, :, :L], cut_out[0])
    assert torch.equal(lse[0, :, :L], cut_lse[0])
    assert torch.equal(lo[0, :, :L], cut_lo[0])
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
    out_res, _, _ = A.splash_attention_fwd_res(qs, k, v, mask)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.ones_like(out))
    assert torch.equal(out_res, out)
    same = (mask[:, :, None] == mask[:, None, :])[:, None]
    s = (qs.float() @ k.float().transpose(-1, -2)).masked_fill(~same, A.SPLASH_MASK_VALUE)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    hi = (p.view(torch.int32) & -65536).view(torch.float32)
    cut = (hi.sum(-1) / p.sum(-1)).to(torch.bfloat16)
    assert float((cut < 1).float().mean()) > 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_kernels_route_by_dtype(cuda, dtype):
    """bf16 inputs reach the tensor-core kernels and nothing else; f32 inputs
    the CUDA-core kernels (true f32): K2's inference and training forwards,
    K2's dk/dv and dq kernels, K4's forward, K4's dk/dv and dq kernels, and
    K3 at both built widths. Each call launches one variant, once, as the
    libraries' own launch tables count it (chip_smoke's ``variants_launched``;
    torch.profiler loses records of such short runs)."""
    q, k, v, do, mask = _attention_inputs(2, 2, 130, 64, dtype, cuda, seed=9)
    bf16 = dtype == torch.bfloat16
    counts = (A.flash_attention.launches, A.flash_attention_fwd_res.launches,
              A.flash_attention_bwd_dkv.launches, A.splash_attention_fwd_res.launches,
              A.flash_attention_bwd_dq.launches, A.splash_attention_bwd_dkv.launches,
              A.splash_attention_bwd_dq.launches, K3.fused_ln_ffn_residual.launches)

    def only(fn, key):
        launched = variants_launched(fn)
        names = [n for n in launched if key in n]
        assert len(names) == 1 and launched[names[0]] == 1, launched
        return names[0]

    with torch.no_grad():
        inference = only(lambda: A.flash_attention(q, k, v, mask, 0.125), "flash_fwd")
    flash = only(lambda: A.flash_attention_fwd_res(q, k, v, mask, 0.125), "flash_fwd")
    out, stats = A.flash_attention_fwd_res(q, k, v, mask, 0.125)
    delta = (do.float() * out.float()).sum(-1).contiguous()
    dkv = only(lambda: A.flash_attention_bwd_dkv(q, k, v, do, stats, delta, mask, 0.125),
               "flash_bwd")
    dq = only(lambda: A.flash_attention_bwd_dq(q, k, v, do, stats, delta, mask, 0.125),
              "flash_bwd")
    splash = only(lambda: A.splash_attention_fwd_res(q, k, v, mask), "splash_fwd")
    lse = A.splash_attention_fwd_res(q, k, v, mask)[1]
    splash_dkv = only(lambda: A.splash_attention_bwd_dkv(q, k, v, do, lse, delta, mask),
                      "splash_bwd")
    splash_dq = only(lambda: A.splash_attention_bwd_dq(q, k, v, do, lse, delta, mask),
                     "splash_bwd")
    ffn = []
    for D, H in K3.WIDTHS:
        weights = [torch.ones(D, device=cuda), torch.zeros(D, device=cuda),
                   torch.randn(D, H, device=cuda) / D, torch.zeros(H, device=cuda),
                   torch.randn(H, D, device=cuda) / H, torch.zeros(D, device=cuda)]
        x = torch.randn(2, 70, D, device=cuda).to(dtype)
        ffn.append(only(lambda: K3.fused_ln_ffn_residual(x, *weights), "fused_ffn"))
    assert (A.flash_attention.launches, A.flash_attention_fwd_res.launches,
            A.flash_attention_bwd_dkv.launches, A.splash_attention_fwd_res.launches,
            A.flash_attention_bwd_dq.launches, A.splash_attention_bwd_dkv.launches,
            A.splash_attention_bwd_dq.launches, K3.fused_ln_ffn_residual.launches) == (
        counts[0] + 1, counts[1] + 2, counts[2] + 1, counts[3] + 2, counts[4] + 1, counts[5] + 1,
        counts[6] + 1, counts[7] + 2)
    assert ("flash_fwd_mma_kernel" in inference) == bf16, inference
    assert ("flash_fwd_kernel" in inference) == (not bf16), inference
    assert ("flash_fwd_stats_mma_kernel" in flash) == bf16, flash
    assert "flash_fwd_stats" in flash, flash
    assert ("flash_bwd_dkv_mma_kernel" in dkv) == bf16, dkv
    assert "flash_bwd_dkv" in dkv, dkv
    assert ("splash_fwd_mma_kernel" in splash) == bf16, splash
    assert ("flash_bwd_dq_mma_kernel" in dq) == bf16 and "flash_bwd_dq" in dq, dq
    assert ("splash_bwd_dkv_mma_kernel" in splash_dkv) == bf16, splash_dkv
    assert "splash_bwd_dkv" in splash_dkv, splash_dkv
    assert ("splash_bwd_dq_mma_kernel" in splash_dq) == bf16, splash_dq
    assert ("splash_bwd_dq_kernel" in splash_dq) == (not bf16), splash_dq
    for name in ffn:
        assert ("fused_ffn_mma_kernel" in name) == bf16, name
        assert ("fused_ffn_kernel" in name) == (not bf16), name


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
        with torch.no_grad(), pytest.raises(ValueError, match="16-byte"):
            A._launch(ok, ok, bad, None, 0.1)
        with pytest.raises(ValueError, match="16-byte"):
            A.splash_attention_fwd_res(ok, ok, bad, None)
        with torch.no_grad(), pytest.raises(ValueError, match="16-byte"):
            A._splash_forward(ok, bad, ok, None, A.splash_attention)


def test_bf16_backward_refuses_misaligned_rows():
    """The bf16 K2 dq, K4 dk/dv and K4 dq kernels copy 16-byte rows with
    cp.async as the forwards do: a misaligned bf16 row raises before any
    launch."""
    storage = torch.zeros(2 * 2 * 16 * 32 + 1, dtype=torch.bfloat16)
    shifted = storage[1:].view(2, 2, 16, 32)
    wide = torch.zeros(2, 2, 16, 36, dtype=torch.bfloat16)[..., :32]
    ok = torch.zeros(2, 2, 16, 32, dtype=torch.bfloat16)
    stats, rows = torch.ones(2, 2, 16, 2), torch.zeros(2, 2, 16)
    for bad in (shifted, wide):
        with pytest.raises(ValueError, match="16-byte"):
            A.flash_attention_bwd_dq(ok, ok, ok, bad, stats, rows, None, 0.1)
        with pytest.raises(ValueError, match="16-byte"):
            A.flash_attention_bwd_dkv(bad, ok, ok, ok, stats, rows, None, 0.1)
        with pytest.raises(ValueError, match="16-byte"):
            A.splash_attention_bwd_dkv(ok, bad, ok, ok, rows, rows, None)
        with pytest.raises(ValueError, match="16-byte"):
            A.splash_attention_bwd_dq(ok, ok, bad, ok, rows, rows, None)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(8192, 512, 2048), (1024, 2048, 512), (136, 512, 1024)])
def test_int8_product_on_card_is_exact(cuda, m, k, n):
    """cuBLASLt's int8 product (torch._int_mm, the int8 serving path) at the
    model's shapes, M down to the smallest bucket's, equals the exact
    product of the same codes (float64: every partial sum is an integer
    below 2^53), and int8_matmul's f32 rescale equals the exact product's."""
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=cuda, dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=gen, device=cuda, dtype=torch.int8)
    sw = torch.rand(n, generator=gen, device=cuda) / 127
    sx = torch.tensor(0.01, device=cuda)
    exact = torch.matmul(xq.double(), wq.double().t())
    assert torch.equal(torch._int_mm(xq, wq.t()).double(), exact)
    got = quant.int8_matmul(xq, sx, wq, sw, torch.float32)
    assert torch.equal(got, exact.float() * (sx * sw))
