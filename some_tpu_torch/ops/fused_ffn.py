"""Fused LayerNorm -> FFN -> scaled residual (the conformer's macaron FFN), inference.

Counterpart of ``some_tpu/ops/fused_ffn.py``. On a CUDA tensor
:func:`fused_ln_ffn_residual` launches the hand-written Hopper kernel of
``csrc/fused_ffn.cu`` (which replaces the Pallas TPU kernel ``_ffn_kernel``:
bf16 on the tensor cores, f32 on the CUDA cores) and counts it in
``fused_ln_ffn_residual.launches``; on a CPU tensor it runs
:func:`fused_ln_ffn_residual_plain`. The bf16 kernel loads rows with TMA,
so a bf16 x or weight whose rows are not 16-byte aligned raises; there is
no fallback.

The arithmetic is the JAX kernel's, not the unfused FeedForward's: the
LayerNorm variance is ``mean((x - mu)^2)`` in f32, the normalized rows are
rounded to x's dtype before the product with W1 (cast to x's dtype, summed
in f32), b1 and b2 are added in f32, SiLU runs in f32, the hidden rows are
rounded to x's dtype before the product with W2, and the residual
``y * res_scale + x`` is formed in f32 and cast to x's dtype.

Inference only, as in JAX (which has no VJP for the kernel): a CUDA call
with a tensor that needs a gradient raises. Weights follow the JAX layout,
w1 ``[D, H]`` and w2 ``[H, D]``; the model passes transposed views of its
``[out, in]`` Linear weights, which the kernel reads as they are stored.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from some_tpu_torch.ops import _build

# (D, H) pairs the kernel is built for: the configs' width and the tests'
WIDTHS = ((64, 256), (512, 2048))
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_ln_ffn_residual_plain(x: torch.Tensor, ln_scale, ln_bias, w1, b1, w2, b2,
                                eps: float = 1e-5, res_scale: float = 0.5) -> torch.Tensor:
    """x ``[..., D]`` -> ``x + res_scale * (SiLU(LN(x) W1 + b1) W2 + b2)``, step
    for step as the JAX kernel computes it (see the module docstring)."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) * (xf - mu)).mean(dim=-1, keepdim=True)
    ln = (xf - mu) * torch.rsqrt(var + eps)
    ln = ln * ln_scale.float() + ln_bias.float()
    h = torch.matmul(ln.to(dt).float(), w1.to(dt).float()) + b1.float()
    h = h * torch.sigmoid(h)
    y = torch.matmul(h.to(dt).float(), w2.to(dt).float()) + b2.float()
    return (y * res_scale + xf).to(dt)


def _check(x, ln_scale, ln_bias, w1, b1, w2, b2):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused FFN kernel takes float32 or bfloat16 x, got {x.dtype}")
    D = x.shape[-1]
    H = w1.shape[-1]
    if (D, H) not in WIDTHS:
        raise ValueError(f"fused FFN kernel is built for (dim, hidden) in {WIDTHS}, "
                         f"got ({D}, {H})")
    if (tuple(w1.shape) != (D, H) or tuple(w2.shape) != (H, D) or b1.shape != (H,)
            or any(t.shape != (D,) for t in (ln_scale, ln_bias, b2))):
        raise ValueError(f"want w1 [D,H], w2 [H,D], b1 [H] and D-vectors, got "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)}, {tuple(b1.shape)}")
    device = x.get_device()
    if any(t.get_device() != device for t in (ln_scale, ln_bias, w1, b1, w2, b2)):
        raise ValueError("x and the FFN's weights must be on one device")


@functools.cache
def _kernel():
    """The C entry point, typed once: the launch runs on every macaron FFN of
    every forward, so its host time counts."""
    fn = _build.load("fused_ffn").some_fused_ln_ffn_residual
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    return fn


def _launch(x, ln_scale, ln_bias, w1, b1, w2, b2, eps, res_scale):
    _build.refuse_grad("fused_ln_ffn_residual", x, ln_scale, ln_bias, w1, b1, w2, b2)
    _check(x, ln_scale, ln_bias, w1, b1, w2, b2)
    shape = x.shape
    D = shape[-1]
    x2 = x.reshape(-1, D).contiguous()
    # [out, in] storage, as torch's Linear keeps it: a view's transpose is free
    w1t = w1.t().to(x.dtype).contiguous()
    w2t = w2.t().to(x.dtype).contiguous()
    _build.check_rows_aligned("fused_ln_ffn_residual", x2, w1t, w2t)
    vecs = [t.float().contiguous() for t in (ln_scale, ln_bias, b1, b2)]
    out = torch.empty(shape, dtype=x.dtype, device=x.device)  # [N, D] rows, contiguous
    err = _kernel()(x2.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(), w1t.data_ptr(),
                    vecs[2].data_ptr(), w2t.data_ptr(), vecs[3].data_ptr(), out.data_ptr(),
                    x2.shape[0], D, w1.shape[-1], float(eps), float(res_scale),
                    _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_ln_ffn_residual")
    fused_ln_ffn_residual.launches += 1
    return out


def fused_ln_ffn_residual(x: torch.Tensor, ln_scale, ln_bias, w1, b1, w2, b2,
                          eps: float = 1e-5, res_scale: float = 0.5,
                          impl: str = "auto") -> torch.Tensor:
    """x ``[B, T, D]`` -> ``x + res_scale * FFN(LN(x))`` in one pass.

    ``impl='auto'`` launches the CUDA kernel for a CUDA tensor and runs the
    plain version for a CPU tensor; ``impl='plain'`` runs the plain version
    anywhere (for comparing the two on the card; no config key reads it)."""
    if impl == "plain" or (impl == "auto" and x.device.type == "cpu"):
        return fused_ln_ffn_residual_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, eps, res_scale)
    if impl != "auto":
        raise ValueError(f"unknown fused FFN impl {impl!r} (auto | plain)")
    if x.device.type != "cuda":
        raise RuntimeError(f"no fused FFN kernel for device {x.device}")
    return _launch(x, ln_scale, ln_bias, w1, b1, w2, b2, eps, res_scale)


fused_ln_ffn_residual.launches = 0
