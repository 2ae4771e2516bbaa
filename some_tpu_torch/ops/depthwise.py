"""Depthwise temporal convolution (the conformer's k=31), forward and backward.

Counterpart of ``some_tpu/ops/depthwise.py``. On a CUDA tensor
:func:`depthwise_conv1d` runs the hand-written Hopper kernels of
``csrc/depthwise_conv.cu`` (which replace the Pallas TPU kernel ``_dw_kernel``
and the XLA weight-gradient reduction of its custom VJP) through
:class:`DepthwiseConv1dFn`; on a CPU tensor it runs
:func:`depthwise_conv1d_plain`, whose autograd is the plain backward.

Backward, as the JAX custom VJP: ``dx`` is the forward kernel on the
cotangent with the taps read in reverse order (:func:`depthwise_conv1d_dx`;
the kernel takes the order as an argument, so no flipped copy of w is made),
``dw`` a per-tap f32 reduction over batch and time cast to w's dtype
(:func:`depthwise_conv1d_dw`). Each of the three counts its own launches.

Layouts follow the JAX package: x ``[B, T, C]``, w ``[k, C]``, 'SAME' zero
padding in time, odd k. The bias is added by the caller.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from some_tpu_torch.ops import _build

# the tap counts the kernels are built for: every config's kernel_size, and 7
KERNEL_TAPS = (7, 31)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# the C entry points of csrc/depthwise_conv.cu and their arguments, bound once
_SIGNATURES = {
    "some_depthwise_conv1d_fwd": [_PTR] * 3 + [_INT] * 6 + [_PTR],
    "some_depthwise_conv1d_dw_parts": [_INT] * 5,
    "some_depthwise_conv1d_dw": [_PTR] * 4 + [_INT] * 6 + [_PTR],
}
_lib = None


def _library() -> ctypes.CDLL:
    """The built kernels with their signatures bound (on first use)."""
    global _lib
    if _lib is None:
        lib = _build.load("depthwise_conv")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        _lib = lib
    return _lib


def depthwise_conv1d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: an f32 sum of k shifted slices, cast to x's
    dtype. No cuDNN, so TF32 cannot enter on the card; the products and sums
    are rounded one by one in tap order, as the kernel does."""
    k = w.shape[0]
    half = (k - 1) // 2
    T = x.shape[1]
    xp = torch.nn.functional.pad(x.float(), (0, 0, half, k - 1 - half))
    wf = w.float()
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for tap in range(k):
        y = y + xp[:, tap:tap + T, :] * wf[tap]
    return y.to(x.dtype)


def depthwise_conv1d_dw_plain(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """The plain weight gradient, as the JAX custom VJP writes it: for each
    tap an f32 sum over batch and time of the shifted input times the
    cotangent, cast to x's dtype."""
    half = (k - 1) // 2
    T = x.shape[1]
    xp = torch.nn.functional.pad(x.float(), (0, 0, half, k - 1 - half))
    gf = g.float()
    return torch.stack([(xp[:, tap:tap + T, :] * gf).sum(dim=(0, 1))
                        for tap in range(k)]).to(x.dtype)


def _check(x: torch.Tensor, w_shape, w_dtype, w_device) -> None:
    if x.dtype not in _DTYPE_CODES or w_dtype != x.dtype:
        raise TypeError(f"depthwise kernel takes float32 or bfloat16 x and w of "
                        f"one dtype, got {x.dtype} and {w_dtype}")
    if x.dim() != 3 or len(w_shape) != 2 or w_shape[1] != x.shape[2]:
        raise ValueError(f"want x [B,T,C] and w [k,C], got {tuple(x.shape)} "
                         f"and {tuple(w_shape)}")
    if w_shape[0] not in KERNEL_TAPS:
        raise ValueError(f"depthwise kernel supports k in {KERNEL_TAPS}, got {w_shape[0]}")
    if w_device != x.device:
        raise ValueError("x and w must be on one device")


def _launch(x: torch.Tensor, w: torch.Tensor, counter, flip: bool = False) -> torch.Tensor:
    """One forward kernel launch; ``flip`` reads the taps in reverse order."""
    _build.refuse_grad("depthwise_conv1d", x, w)
    _check(x, w.shape, w.dtype, w.device)
    x = x.contiguous()
    w = w.contiguous()
    y = torch.empty_like(x)
    fn = _library().some_depthwise_conv1d_fwd
    B, T, C = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), B, T, C, w.shape[0],
             _DTYPE_CODES[x.dtype], int(flip), stream)
    _build.check(err, "depthwise_conv1d")
    counter.launches += 1
    return y


def depthwise_conv1d_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The input gradient on the card: the forward kernel on the cotangent
    ``g`` with the taps in reverse order (correlation <-> convolution, odd
    k), equal bit for bit to ``depthwise_conv1d_plain(g, w.flip(0))``.
    ``depthwise_conv1d_dx.launches`` counts its launches."""
    return _launch(g, w, depthwise_conv1d_dx, flip=True)


@functools.lru_cache(maxsize=None)
def _dw_parts(device: int, B: int, T: int, C: int, k: int, code: int) -> int:
    """How many f32 partials [k, C] the weight gradient writes at this shape
    on this device (asked of the library once a shape)."""
    with torch.cuda.device(device):
        n_parts = _library().some_depthwise_conv1d_dw_parts(B, T, C, k, code)
    _build.check(min(n_parts, 0), "depthwise_conv1d_dw")
    return n_parts


def depthwise_conv1d_dw(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """The weight gradient on the card, ``dw[tap, c] = sum_{b,t}
    x[b, t + tap - (k-1)/2, c] * g[b, t, c]`` in f32, cast to x's dtype:
    the partials kernel (one partial per block, as many blocks as fill the
    card) and the fixed-order reduce, counted as one launch in
    ``depthwise_conv1d_dw.launches``."""
    _build.refuse_grad("depthwise_conv1d_dw", x, g)
    _check(x, (k, x.shape[2]), g.dtype, g.device)
    if g.shape != x.shape:
        raise ValueError(f"want x and g of one shape, got {tuple(x.shape)} and {tuple(g.shape)}")
    x = x.contiguous()
    g = g.contiguous()
    B, T, C = x.shape
    code = _DTYPE_CODES[x.dtype]
    n_parts = _dw_parts(x.device.index, B, T, C, k, code)
    partial = torch.empty((n_parts, k, C), dtype=torch.float32, device=x.device)
    dw = torch.empty((k, C), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().some_depthwise_conv1d_dw(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                                              dw.data_ptr(), B, T, C, k, code, n_parts, stream)
    _build.check(err, "depthwise_conv1d_dw")
    depthwise_conv1d_dw.launches += 1
    return dw


class DepthwiseConv1dFn(torch.autograd.Function):
    """The kernels as one differentiable op: forward kernel, ``dx`` by the
    same kernel with the taps in reverse order, ``dw`` by the reduction
    kernels."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _launch(x, w, depthwise_conv1d)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = depthwise_conv1d_dx(g, w) if ctx.needs_input_grad[0] else None
        dw = depthwise_conv1d_dw(x, g, w.shape[0]) if ctx.needs_input_grad[1] else None
        return dx, dw


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """y[b,t,c] = sum_tap x[b, t + tap - (k-1)/2, c] * w[tap, c].

    ``impl='auto'`` runs the CUDA kernels for a CUDA tensor (through
    :class:`DepthwiseConv1dFn` where x or w needs a gradient, else launched
    directly) and the plain version for a CPU tensor; ``impl='plain'`` runs
    the plain version anywhere (the counterpart of the JAX ``impl='xla'``).
    ``depthwise_conv1d.launches`` counts forward kernel launches."""
    if w.shape[0] % 2 != 1:
        raise ValueError("depthwise kernel size must be odd")
    if impl == "plain" or (impl == "auto" and x.device.type == "cpu"):
        return depthwise_conv1d_plain(x, w)
    if impl != "auto":
        raise ValueError(f"unknown depthwise impl {impl!r} (auto | plain)")
    if x.device.type != "cuda":
        raise RuntimeError(f"no depthwise kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return DepthwiseConv1dFn.apply(x, w)
    return _launch(x, w, depthwise_conv1d)


depthwise_conv1d.launches = 0
depthwise_conv1d_dx.launches = 0
depthwise_conv1d_dw.launches = 0
