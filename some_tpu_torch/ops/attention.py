"""Masked self-attention over ``[B, H, T, D]``, forward and backward.

Counterpart of ``some_tpu/ops/attention.py``, with two kernel families of
different semantics, as in the JAX package:

* **flash** (``attention_impl`` 'auto' / 'flash'; K2). On a CUDA tensor
  :func:`flash_attention` launches the hand-written Hopper kernels that
  replace the Pallas TPU flash kernels behind ``_flash_attention_bhtd``; on
  a CPU tensor it runs :func:`attention_plain`, the arithmetic of the JAX
  ``_xla_attention``. The port follows ``_xla_attention``: a masked key
  scores the finite ``NEG_INF``, so a padded query attends the real keys and
  a row with no real key (a batch-padding row) averages v instead of turning
  into NaN; P is rounded to the input dtype before P.V.
* **splash** (``attention_impl: splash``; K4). :func:`splash_attention`
  follows the JAX ``_splash_attention_bhtd`` and splash's own kernels: q is
  pre-scaled in its dtype outside the kernel, padding is expressed as
  **segment ids** (a padded query attends only padded keys, a real query
  only real keys) with splash's mask value ``-0.7 * FLT_MAX``, P stays f32
  in P.V and is normalized once at the end, and the training forward keeps
  one f32 log-sum-exp per row. Its kernels are ``csrc/splash_attention.cu``
  and ``csrc/splash_attention_bwd.cu``; :func:`splash_attention_plain` is
  splash's reference, and a CPU tensor runs it.

On the card, a call that needs no gradient launches the inference kernel
(counted in ``flash_attention.launches`` / ``splash_attention.launches``). A
call whose q, k or v needs a gradient goes through
:class:`FlashAttentionFn` / :class:`SplashAttentionFn`: the training forward
also stores the row statistics (``*_fwd_res.launches``), and the backward
runs the dk/dv and dq kernels (``*_bwd_dkv.launches``, ``*_bwd_dq.launches``)
after ``rowsum(dO * O)`` in plain PyTorch, as JAX computes it in XLA. With O
rounded to bf16 that sum is off by about 2^-9, which took the bf16 gradients
past the f32 bound: K2's dq kernel corrects it to rowsum(P dP) and runs
first; K4's training forward stores the output's rounding residual, and
:func:`splash_di` adds it back before the sum. The
gradients are written in ``[B, T, H, D]`` storage viewed as ``[B, H, T, D]``,
the layout of the projections q, k and v are views of, so the transposes
back cost nothing; the concatenation of dk and dv into the fused kv
projection's gradient is the one copy, as with any split.

In bf16 every attention kernel (K2's inference and training forwards, K2's
dk/dv and dq kernels, the splash forward, K4's dk/dv and dq kernels) runs on
the tensor cores (``csrc/attention_mma.cuh``), which copy 16-byte rows with
``cp.async``: their wrappers raise on a bf16 row that is not 16-byte
aligned. f32 runs on the CUDA cores in true f32.

The two JAX paths differ on padded frames; PERF.md says where that reaches a
training loss.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from some_tpu_torch.ops import _build

NEG_INF = -1e9
HEAD_DIMS = (32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """q, k, v ``[B, H, T, D]``, mask ``[B, T]`` bool or None -> ``[B, H, T, D]``.

    Scores and softmax in f32, the weights cast to q's dtype before the
    product with v, f32 sums, output in q's dtype. Stores ``[B, H, T, T]``."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(weights.float(), v.float()).to(q.dtype)


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 3)(*t.stride()[:3])


def _check(q, k, v, mask):
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention kernels take float32 or bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"want q, k, v of one shape [B,H,T,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, T, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"attention kernels support head_dim in {HEAD_DIMS}, got {D}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("q, k, v must be on one device")
    if mask is not None and (mask.shape != (B, T) or mask.dtype != torch.bool
                             or mask.device != q.device):
        raise ValueError(f"want a bool mask [B,T] on {q.device}, got "
                         f"{mask.dtype} {tuple(mask.shape)} on {mask.device}")


def _last_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _bhtd_like(q: torch.Tensor) -> torch.Tensor:
    """An empty [B, H, T, D] tensor in [B, T, H, D] storage: the caller's
    transpose back to [B, T, H*D] is free."""
    B, H, T, D = q.shape
    return torch.empty((B, T, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)


def _mask_ptr(mask):
    """The mask's address; _check has made sure it is a [B, T] bool tensor,
    which its constructors make contiguous."""
    if mask is None:
        return None
    if not mask.is_contiguous():
        raise ValueError("the attention mask must be contiguous")
    return mask.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _fn(name: str, n_ptrs: int, n_strides: int):
    """The C entry point ``name`` from its library (flash or splash, forward
    or backward), typed: the pointers, the four sizes, the stride arrays,
    the flash kernels' scale (splash's q arrives pre-scaled), the dtype code
    and the stream."""
    family = "splash_attention" if "splash" in name else "flash_attention"
    fn = getattr(_build.load(family + ("_bwd" if "bwd" in name else "")), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_longlong)] * n_strides
                   + ([] if family == "splash_attention" else [ctypes.c_float])
                   + [ctypes.c_int, ctypes.c_void_p])
    return fn


def _launch(q, k, v, mask, scale):
    """The inference forward kernel."""
    _build.refuse_grad("flash_attention", q, k, v)
    _check(q, k, v, mask)
    B, H, T, D = q.shape
    q, k, v = (_last_contiguous(t) for t in (q, k, v))
    out = _bhtd_like(q)
    _build.check_rows_aligned("flash_attention", q, k, v, out)
    err = _fn("some_flash_attention_fwd", 5, 4)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(mask), out.data_ptr(),
        B, H, T, D, _strides(q), _strides(k), _strides(v), _strides(out),
        float(scale), _DTYPE_CODES[q.dtype], _stream(q))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


def flash_attention_fwd_res(q, k, v, mask, scale):
    """The training forward kernel: the output and the f32 row statistics
    (m, l) ``[B, H, T, 2]`` the backward rebuilds P from."""
    _build.refuse_grad("flash_attention_fwd_res", q, k, v)
    _check(q, k, v, mask)
    B, H, T, D = q.shape
    q, k, v = (_last_contiguous(t) for t in (q, k, v))
    out = _bhtd_like(q)
    _build.check_rows_aligned("flash_attention_fwd_res", q, k, v, out)
    stats = torch.empty((B, H, T, 2), dtype=torch.float32, device=q.device)
    err = _fn("some_flash_attention_fwd_stats", 6, 4)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(mask), out.data_ptr(),
        stats.data_ptr(), B, H, T, D, _strides(q), _strides(k), _strides(v),
        _strides(out), float(scale), _DTYPE_CODES[q.dtype], _stream(q))
    _build.check(err, "flash_attention_fwd_res")
    flash_attention_fwd_res.launches += 1
    return out, stats


def _split_bf16(x: torch.Tensor) -> torch.Tensor:
    """An f32 tensor as the two bf16 operands the tensor-core kernels take
    for it, summed back in f32: hi its value cut to bf16, lo the rest
    rounded (``split_bf16`` in ``csrc/attention_mma.cuh``)."""
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return hi + (x - hi).to(torch.bfloat16).float()


def flash_attention_bwd_dkv_plain(q, k, v, dout, stats, delta, mask, scale):
    """dk, dv ``[B, H, T, D]`` with the dk/dv kernel's rounding points, from
    the forward's row statistics ``stats`` (m, l) ``[B, H, T, 2]`` and
    ``delta = rowsum(dO * O)`` ``[B, H, T]``, both f32: P rebuilt as
    exp(score - m) * (1 / l), dV = round(P)^T dO, dP = dO V^T in f32,
    dS = P (dP - delta) and 0 at a masked key, then dK = (dS * scale)^T Q.
    In bf16 the kernel takes dS * scale as hi + lo, two bf16 operands (hi its
    value cut to bf16, lo the rest rounded), where JAX's kernel rounds it to
    bf16 once; this function does the same."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.exp(s - stats[..., :1]) * (1.0 / stats[..., 1:])
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), dout.float())
    ds = p * (torch.matmul(dout.float(), v.float().transpose(-1, -2)) - delta[..., None])
    if mask is not None:
        ds = ds.masked_fill(~mask[:, None, None, :], 0.0)
    ds = ds * scale
    if q.dtype == torch.bfloat16:
        ds = _split_bf16(ds)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_bwd_dq_plain(q, k, v, dout, stats, delta, mask, scale):
    """dq ``[B, H, T, D]`` and the corrected delta ``[B, H, T]`` f32 with the
    dq kernel's rounding points, from the forward's (m, l) and a given
    ``delta``: P rebuilt as in :func:`flash_attention_bwd_dkv_plain` and kept
    at the real keys only, dS = P (dP - delta) in f32, r = the row sum of
    dS, then dq = (dS * scale) K - (r * scale) (round(P) K), the dq of
    delta + r = rowsum(P dP), and delta + r. In bf16 the kernel takes
    dS * scale as hi + lo and P rounded to bf16 (identities in f32); this
    function does the same. An all-masked row gets dq = 0 and its delta."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.exp(s - stats[..., :1]) * (1.0 / stats[..., 1:])
    if mask is not None:
        p = p.masked_fill(~mask[:, None, None, :], 0.0)
    ds = p * (torch.matmul(dout.float(), v.float().transpose(-1, -2)) - delta[..., None])
    r = ds.sum(-1)
    ds = ds * scale
    if q.dtype == torch.bfloat16:
        ds = _split_bf16(ds)
    pk = torch.matmul(p.to(q.dtype).float(), k.float())
    dq = torch.matmul(ds, k.float()) - (r * scale)[..., None] * pk
    return dq.to(q.dtype), delta + r


def flash_attention_bwd_dkv(q, k, v, dout, stats, delta, mask, scale):
    """dk, dv from the dk/dv kernel."""
    _build.refuse_grad("flash_attention_bwd_dkv", q, k, v, dout)
    _build.check_rows_aligned("flash_attention_bwd_dkv", q, k, v, dout)
    B, H, T, D = q.shape
    dk, dv = _bhtd_like(q), _bhtd_like(q)
    err = _fn("some_flash_attention_bwd_dkv", 9, 6)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), stats.data_ptr(),
        delta.data_ptr(), _mask_ptr(mask), dk.data_ptr(), dv.data_ptr(), B, H, T, D,
        _strides(q), _strides(k), _strides(v), _strides(dout), _strides(dk), _strides(dv),
        float(scale), _DTYPE_CODES[q.dtype], _stream(q))
    _build.check(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, dout, stats, delta, mask, scale):
    """dq from the dq kernel, and the row sums of P dP it found ``[B, H, T]``
    f32: ``delta`` corrected by the sum of dS = P (dP - delta) over the real
    keys, which the kernel also takes out of dq."""
    _build.refuse_grad("flash_attention_bwd_dq", q, k, v, dout)
    B, H, T, D = q.shape
    dq = _bhtd_like(q)
    _build.check_rows_aligned("flash_attention_bwd_dq", q, k, v, dout, dq)
    delta_out = torch.empty_like(delta)
    err = _fn("some_flash_attention_bwd_dq", 9, 5)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), stats.data_ptr(),
        delta.data_ptr(), _mask_ptr(mask), dq.data_ptr(), delta_out.data_ptr(), B, H, T, D,
        _strides(q), _strides(k), _strides(v), _strides(dout), _strides(dq),
        float(scale), _DTYPE_CODES[q.dtype], _stream(q))
    _build.check(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq, delta_out


def flash_attention_backward(q, k, v, out, dout, stats, mask, scale):
    """dq, dk, dv on the card from the forward's inputs, output and
    statistics: ``delta = rowsum(dO * O)`` in f32, as JAX takes it, then the
    dq kernel, which corrects delta to the rowsum of P dP (O is rounded to
    the input dtype; ``csrc/flash_attention_bwd.cu``), then the dk/dv kernel
    on the corrected delta."""
    _check(q, k, v, mask)
    q, k, v, dout = (_last_contiguous(t) for t in (q, k, v, dout))
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    dq, delta = flash_attention_bwd_dq(q, k, v, dout, stats, delta, mask, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, stats, delta, mask, scale)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """The kernels as one differentiable op; saves q, k, v, the output, the
    row statistics and the mask. The mask and the scale get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        out, stats = flash_attention_fwd_res(q, k, v, mask, scale)
        ctx.save_for_backward(q, k, v, out, stats, mask)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, stats, mask = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout, stats, mask, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """``[B, H, T, D]`` attention: the CUDA kernels for a CUDA tensor
    (through :class:`FlashAttentionFn` when q, k or v needs a gradient), the
    plain version for a CPU tensor. q, k and v may be strided views."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no attention kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, mask, scale)
    return _launch(q, k, v, mask, scale)


flash_attention.launches = 0
flash_attention_fwd_res.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0


# ---- splash attention (K4): segment ids, a pre-scaled q, one log-sum-exp ----

# splash's DEFAULT_MASK_VALUE: the score of a key in another segment
SPLASH_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def prescale(q: torch.Tensor, scale: float) -> torch.Tensor:
    """``(q * scale)`` in q's dtype, as the JAX wrapper forms it outside the
    kernel: a Python scale meets a bf16 array as a bf16 number, so the scale
    is rounded to q's dtype first."""
    return q * float(torch.tensor(scale, dtype=q.dtype))


def _segment_mask(mask: torch.Tensor) -> torch.Tensor:
    """[B, T] bool -> [B, 1, T, T]: query and key in one segment (0 pad, 1 real)."""
    return (mask[:, :, None] == mask[:, None, :])[:, None]


def splash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """q, k, v ``[B, H, T, D]``, mask ``[B, T]`` bool or None -> ``[B, H, T, D]``.

    Splash's own reference (``_attention_reference_default``) inside the JAX
    wrapper ``_splash_attention_bhtd``: q pre-scaled in its dtype, f32
    scores, ``SPLASH_MASK_VALUE`` across segments, f32 softmax, P times v
    upcast in f32 (P not rounded), output in q's dtype. Autograd gives the
    gradients, through the pre-scale as JAX's do."""
    qs = prescale(q, scale)
    scores = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    if mask is not None:
        scores = scores.masked_fill(~_segment_mask(mask), SPLASH_MASK_VALUE)
    weights = torch.softmax(scores, dim=-1)
    return torch.matmul(weights, v.float()).to(q.dtype)


def _splash_forward(qs, k, v, mask, counter):
    """The forward kernel on a pre-scaled q, counted in ``counter.launches``;
    with the log-sum-exp, and in bf16 the output's rounding residual, when
    ``counter`` is :func:`splash_attention_fwd_res`."""
    _build.refuse_grad(counter.__name__, qs, k, v)
    _check(qs, k, v, mask)
    B, H, T, D = qs.shape
    qs, k, v = (_last_contiguous(t) for t in (qs, k, v))
    out = _bhtd_like(qs)
    _build.check_rows_aligned(counter.__name__, qs, k, v, out)
    training = counter is splash_attention_fwd_res
    lse = torch.empty((B, H, T), dtype=torch.float32, device=qs.device) if training else None
    out_lo = _bhtd_like(qs) if training and qs.dtype == torch.bfloat16 else None
    err = _fn("some_splash_attention_fwd", 7, 4)(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(mask), out.data_ptr(),
        None if lse is None else lse.data_ptr(), None if out_lo is None else out_lo.data_ptr(),
        B, H, T, D, _strides(qs), _strides(k), _strides(v), _strides(out),
        _DTYPE_CODES[qs.dtype], _stream(qs))
    _build.check(err, counter.__name__)
    counter.launches += 1
    return out, lse, out_lo


def splash_attention_fwd_res(qs, k, v, mask):
    """The training forward kernel: the output, each query row's f32
    log-sum-exp ``log(l) + m`` ``[B, H, T]`` (the residual the backward
    rebuilds P from) and, for bf16 inputs, ``out_lo`` (None in f32): what
    rounding the output to bf16 left of each f32 value, rounded to bf16, so
    that :func:`splash_di` takes di from the output to about 2^-16."""
    return _splash_forward(qs, k, v, mask, splash_attention_fwd_res)


def splash_di(out, out_lo, dout):
    """di = rowsum(O * dO) ``[B, H, T]`` in f32, with O = out + out_lo, the
    f32 output to about 2^-16 (``out_lo`` None: O = out). JAX takes O
    rounded to bf16 (``splash_attention_kernel.py:2285``); its error, about
    2^-9, moves dS before splash rounds dS to bf16 and took the bf16 dq and
    dk past 2 ulp + 0.02 RMS of splash's function in f32 (PERF.md)."""
    o = out.float() if out_lo is None else out.float() + out_lo.float()
    return (o * dout.float()).sum(-1).contiguous()


def _splash_p_dp(qs, k, v, dout, lse, mask):
    """Splash's f32 P = exp(score - lse), 0 across segments, and dP = dO V^T
    in f32, from the forward's log-sum-exp ``[B, H, T]``."""
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    if mask is not None:
        s = s.masked_fill(~_segment_mask(mask), SPLASH_MASK_VALUE)
    p = torch.exp(s - lse[..., None])
    return p, torch.matmul(dout.float(), v.float().transpose(-1, -2))


def splash_attention_bwd_dkv_plain(qs, k, v, dout, lse, di, mask, rounding=None):
    """dk, dv ``[B, H, T, D]`` with splash's rounding points (JAX 0.9.0
    ``splash_attention_kernel.py``), from the pre-scaled q, the forward's
    f32 log-sum-exp and ``di`` ``[B, H, T]`` as given: P = exp(score - lse)
    with f32 scores, dV = round(P)^T dO (:1788), dP = dO V^T in f32,
    dS = (dP - di) P, dK = round(dS)^T qs (:1804). ``rounding`` is the dtype
    P and dS are rounded to (qs's by default): bf16 on f32 copies of bf16
    inputs gives the f32 reference of the bf16 function. Out in qs's dtype."""
    rounding = rounding or qs.dtype
    p, dp = _splash_p_dp(qs, k, v, dout, lse, mask)
    dv = torch.matmul(p.to(rounding).float().transpose(-1, -2), dout.float())
    ds = ((dp - di[..., None]) * p).to(rounding).float()
    dk = torch.matmul(ds.transpose(-1, -2), qs.float())
    return dk.to(qs.dtype), dv.to(qs.dtype)


def splash_attention_bwd_dq_plain(qs, k, v, dout, lse, di, mask, rounding=None):
    """The gradient of the pre-scaled q with splash's rounding points:
    dQ = round(dS) K (:1395), dS = (dP - di) P as in
    :func:`splash_attention_bwd_dkv_plain`, di as given. Out in qs's dtype."""
    rounding = rounding or qs.dtype
    p, dp = _splash_p_dp(qs, k, v, dout, lse, mask)
    ds = ((dp - di[..., None]) * p).to(rounding).float()
    return torch.matmul(ds, k.float()).to(qs.dtype)


def splash_attention_bwd_dkv(qs, k, v, dout, lse, di, mask):
    """dk, dv from the dk/dv kernel."""
    _build.refuse_grad("splash_attention_bwd_dkv", qs, k, v, dout)
    B, H, T, D = qs.shape
    dk, dv = _bhtd_like(qs), _bhtd_like(qs)
    _build.check_rows_aligned("splash_attention_bwd_dkv", qs, k, v, dout, dk, dv)
    err = _fn("some_splash_attention_bwd_dkv", 9, 6)(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        di.data_ptr(), _mask_ptr(mask), dk.data_ptr(), dv.data_ptr(), B, H, T, D,
        _strides(qs), _strides(k), _strides(v), _strides(dout), _strides(dk), _strides(dv),
        _DTYPE_CODES[qs.dtype], _stream(qs))
    _build.check(err, "splash_attention_bwd_dkv")
    splash_attention_bwd_dkv.launches += 1
    return dk, dv


def splash_attention_bwd_dq(qs, k, v, dout, lse, di, mask):
    """The gradient of the pre-scaled q from the dq kernel."""
    _build.refuse_grad("splash_attention_bwd_dq", qs, k, v, dout)
    B, H, T, D = qs.shape
    dq = _bhtd_like(qs)
    _build.check_rows_aligned("splash_attention_bwd_dq", qs, k, v, dout, dq)
    err = _fn("some_splash_attention_bwd_dq", 8, 5)(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        di.data_ptr(), _mask_ptr(mask), dq.data_ptr(), B, H, T, D,
        _strides(qs), _strides(k), _strides(v), _strides(dout), _strides(dq),
        _DTYPE_CODES[qs.dtype], _stream(qs))
    _build.check(err, "splash_attention_bwd_dq")
    splash_attention_bwd_dq.launches += 1
    return dq


def splash_attention_backward(qs, k, v, out, out_lo, dout, lse, mask):
    """dqs, dk, dv on the card: di from the forward's output and its
    residual (:func:`splash_di`), then the dk/dv kernel and the dq kernel."""
    _check(qs, k, v, mask)
    qs, k, v, dout = (_last_contiguous(t) for t in (qs, k, v, dout))
    di = splash_di(out, out_lo, dout)
    dk, dv = splash_attention_bwd_dkv(qs, k, v, dout, lse, di, mask)
    dq = splash_attention_bwd_dq(qs, k, v, dout, lse, di, mask)
    return dq, dk, dv


class SplashAttentionFn(torch.autograd.Function):
    """The splash kernels as one differentiable op on the pre-scaled q;
    saves qs, k, v, the output and its residual, the log-sum-exp and the
    mask."""

    @staticmethod
    def forward(ctx, qs, k, v, mask):
        out, lse, out_lo = splash_attention_fwd_res(qs, k, v, mask)
        ctx.save_for_backward(qs, k, v, out, out_lo, lse, mask)
        return out

    @staticmethod
    def backward(ctx, dout):
        qs, k, v, out, out_lo, lse, mask = ctx.saved_tensors
        dq, dk, dv = splash_attention_backward(qs, k, v, out, out_lo, dout, lse, mask)
        return dq, dk, dv, None


def splash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """``[B, H, T, D]`` splash attention: q pre-scaled in plain PyTorch, then
    the CUDA kernels for a CUDA tensor (through :class:`SplashAttentionFn`
    when q, k or v needs a gradient), the plain version for a CPU tensor.
    ``splash_attention.launches`` counts the inference kernel."""
    if q.device.type == "cpu":
        return splash_attention_plain(q, k, v, mask, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no attention kernel for device {q.device}")
    qs = prescale(q, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return SplashAttentionFn.apply(qs, k, v, mask)
    return _splash_forward(qs, k, v, mask, splash_attention)[0]


splash_attention.launches = 0
splash_attention_fwd_res.launches = 0
splash_attention_bwd_dkv.launches = 0
splash_attention_bwd_dq.launches = 0


def attention_bhtd(q, k, v, mask, scale, impl: str, kernel_impl: str = "auto"):
    """Dispatch on the config's ``attention_impl``: 'auto' and 'flash' take
    :func:`flash_attention`, 'splash' :func:`splash_attention`, 'xla'
    :func:`attention_plain` anywhere. ``kernel_impl='plain'`` (a test-only
    switch) runs the chosen family's plain version on any device."""
    if impl not in ("auto", "flash", "splash", "xla"):
        raise ValueError(f"unknown attention_impl {impl!r}")
    if kernel_impl not in ("auto", "plain"):
        raise ValueError(f"unknown attention kernel impl {kernel_impl!r} (auto | plain)")
    if impl == "splash":
        fn = splash_attention_plain if kernel_impl == "plain" else splash_attention
    elif impl == "xla" or kernel_impl == "plain":
        fn = attention_plain
    else:
        fn = flash_attention
    return fn(q, k, v, mask, scale)
