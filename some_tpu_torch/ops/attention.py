"""Masked self-attention over ``[B, H, T, D]``, forward.

Counterpart of ``some_tpu/ops/attention.py``. On a CUDA tensor
:func:`flash_attention` launches the hand-written Hopper kernel
``csrc/flash_attention.cu`` (which replaces the Pallas TPU flash kernel
behind ``_flash_attention_bhtd``) for every T; on a CPU tensor it runs
:func:`attention_plain`, the arithmetic of the JAX ``_xla_attention``.

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


def _launch(q, k, v, mask, scale):
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
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    mask_ptr = None
    if mask is not None:
        if mask.shape != (B, T) or mask.dtype != torch.bool or mask.device != q.device:
            raise ValueError(f"want a bool mask [B,T] on {q.device}, got "
                             f"{mask.dtype} {tuple(mask.shape)} on {mask.device}")
        mask = mask.contiguous()
        mask_ptr = mask.data_ptr()
    # [B, T, H, D] storage: the caller's transpose back to [B, T, H*D] is free
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lib = _build.load("flash_attention")
    fn = lib.some_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_longlong)] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
             B, H, T, D, _strides(q), _strides(k), _strides(v), _strides(out),
             float(scale), _DTYPE_CODES[q.dtype], stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """``[B, H, T, D]`` attention: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. ``flash_attention.launches`` counts
    kernel launches. q, k and v may be strided views (last dim contiguous)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"no attention kernel for device {q.device}")
    return _launch(q, k, v, mask, scale)


flash_attention.launches = 0


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
