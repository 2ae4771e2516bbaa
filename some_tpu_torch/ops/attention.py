"""Masked self-attention over ``[B, H, T, D]``, forward and backward.

Counterpart of ``some_tpu/ops/attention.py``. On a CUDA tensor
:func:`flash_attention` launches the hand-written Hopper kernels (which
replace the Pallas TPU flash kernels behind ``_flash_attention_bhtd``) for
every T; on a CPU tensor it runs :func:`attention_plain`, the arithmetic of
the JAX ``_xla_attention``, whose autograd is the plain backward.

On the card, a call that needs no gradient launches the inference kernel
(``csrc/flash_attention.cu``, counted in ``flash_attention.launches``). A
call whose q, k or v needs a gradient goes through
:class:`FlashAttentionFn`: the training forward also stores each query
row's softmax statistics (m, l) (``flash_attention_fwd_res.launches``), and
the backward runs the dk/dv and dq kernels of ``csrc/flash_attention_bwd.cu``
(``flash_attention_bwd_dkv.launches``, ``flash_attention_bwd_dq.launches``)
after ``delta = rowsum(dO * O)`` in plain PyTorch, as JAX computes it in
XLA. The gradients are written in ``[B, T, H, D]`` storage viewed as
``[B, H, T, D]``, the layout of the projections q, k and v are views of, so
the transposes back cost nothing; the concatenation of dk and dv into the
fused kv projection's gradient is the one copy, as with any split.

The port follows ``_xla_attention``: a padded query attends the real keys.
The JAX TPU flash path (segment ids) lets a padded query attend only padded
keys, so the two JAX paths differ on padded frames; PERF.md says where that
reaches a training loss.

Key-mask semantics are those of ``_xla_attention``: a masked key scores the
finite ``NEG_INF``, so a row with no real key (a batch-padding row) stays
finite instead of turning into NaN, which would reach the decoder.
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
        raise TypeError(f"flash kernel takes float32 or bfloat16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"want q, k, v of one shape [B,H,T,D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, T, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash kernel supports head_dim in {HEAD_DIMS}, got {D}")
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
    fn = getattr(_build.load("flash_attention_bwd" if "bwd" in name else "flash_attention"),
                 name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_longlong)] * n_strides
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _launch(q, k, v, mask, scale):
    """The inference forward kernel."""
    _build.refuse_grad("flash_attention", q, k, v)
    _check(q, k, v, mask)
    B, H, T, D = q.shape
    q, k, v = (_last_contiguous(t) for t in (q, k, v))
    out = _bhtd_like(q)
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
    stats = torch.empty((B, H, T, 2), dtype=torch.float32, device=q.device)
    err = _fn("some_flash_attention_fwd_stats", 6, 4)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(mask), out.data_ptr(),
        stats.data_ptr(), B, H, T, D, _strides(q), _strides(k), _strides(v),
        _strides(out), float(scale), _DTYPE_CODES[q.dtype], _stream(q))
    _build.check(err, "flash_attention_fwd_res")
    flash_attention_fwd_res.launches += 1
    return out, stats


def flash_attention_bwd_dkv(q, k, v, dout, stats, delta, mask, scale):
    """dk, dv from the dk/dv kernel."""
    _build.refuse_grad("flash_attention_bwd_dkv", q, k, v, dout)
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
    """dq from the dq kernel."""
    _build.refuse_grad("flash_attention_bwd_dq", q, k, v, dout)
    B, H, T, D = q.shape
    dq = _bhtd_like(q)
    err = _fn("some_flash_attention_bwd_dq", 8, 5)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), stats.data_ptr(),
        delta.data_ptr(), _mask_ptr(mask), dq.data_ptr(), B, H, T, D,
        _strides(q), _strides(k), _strides(v), _strides(dout), _strides(dq),
        float(scale), _DTYPE_CODES[q.dtype], _stream(q))
    _build.check(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_backward(q, k, v, out, dout, stats, mask, scale):
    """dq, dk, dv on the card from the forward's inputs, output and
    statistics: ``delta = rowsum(dO * O)`` in f32, then the two kernels."""
    _check(q, k, v, mask)
    q, k, v, dout = (_last_contiguous(t) for t in (q, k, v, dout))
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, stats, delta, mask, scale)
    dq = flash_attention_bwd_dq(q, k, v, dout, stats, delta, mask, scale)
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


def attention_bhtd(q, k, v, mask, scale, impl: str):
    """Dispatch on the config's ``attention_impl``: 'auto' and 'flash' take
    :func:`flash_attention`, 'xla' takes :func:`attention_plain` anywhere."""
    if impl in ("auto", "flash"):
        return flash_attention(q, k, v, mask, scale)
    if impl == "xla":
        return attention_plain(q, k, v, mask, scale)
    if impl == "splash":
        raise NotImplementedError(
            "attention_impl 'splash' (the JAX package's splash kernel, K4) is "
            "still to be ported: see ROADMAP.md, queue 2")
    raise ValueError(f"unknown attention_impl {impl!r}")
