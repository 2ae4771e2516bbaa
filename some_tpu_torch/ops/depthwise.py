"""Depthwise temporal convolution (the conformer's k=31), forward.

Counterpart of ``some_tpu/ops/depthwise.py``. On a CUDA tensor
:func:`depthwise_conv1d` launches the hand-written Hopper kernel
``csrc/depthwise_conv.cu`` (which replaces the Pallas TPU kernel
``_dw_kernel``); on a CPU tensor it runs :func:`depthwise_conv1d_plain`.
Only the forward exists: the backward comes with training.

Layouts follow the JAX package: x ``[B, T, C]``, w ``[k, C]``, 'SAME' zero
padding in time, odd k. The bias is added by the caller.
"""
from __future__ import annotations

import ctypes

import torch

from some_tpu_torch.ops import _build

# the tap counts the kernel is built for: every config's kernel_size, and 7
KERNEL_TAPS = (7, 31)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"depthwise kernel takes float32 or bfloat16 x and w of "
                        f"one dtype, got {x.dtype} and {w.dtype}")
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"want x [B,T,C] and w [k,C], got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if w.shape[0] not in KERNEL_TAPS:
        raise ValueError(f"depthwise kernel supports k in {KERNEL_TAPS}, got {w.shape[0]}")
    if w.device != x.device:
        raise ValueError("x and w must be on one device")
    x = x.contiguous()
    w = w.contiguous()
    y = torch.empty_like(x)
    lib = _build.load("depthwise_conv")
    fn = lib.some_depthwise_conv1d_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    B, T, C = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), B, T, C, w.shape[0],
             _DTYPE_CODES[x.dtype], stream)
    _build.check(err, "depthwise_conv1d")
    depthwise_conv1d.launches += 1
    return y


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """y[b,t,c] = sum_tap x[b, t + tap - (k-1)/2, c] * w[tap, c].

    ``impl='auto'`` launches the CUDA kernel for a CUDA tensor and runs the
    plain version for a CPU tensor; ``impl='plain'`` runs the plain version
    anywhere (the counterpart of the JAX ``impl='xla'``).
    ``depthwise_conv1d.launches`` counts kernel launches."""
    if w.shape[0] % 2 != 1:
        raise ValueError("depthwise kernel size must be odd")
    if impl == "plain" or (impl == "auto" and x.device.type == "cpu"):
        return depthwise_conv1d_plain(x, w)
    if impl != "auto":
        raise ValueError(f"unknown depthwise impl {impl!r} (auto | plain)")
    if x.device.type != "cuda":
        raise RuntimeError(f"no depthwise kernel for device {x.device}")
    return _launch(x, w)


depthwise_conv1d.launches = 0
