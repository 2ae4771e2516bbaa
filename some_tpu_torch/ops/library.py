"""The four inference kernels as ``torch.library`` ops (``torch.ops.some_tpu``).

* ``some_tpu::depthwise_conv1d(x, w)`` (K1, ``ops/depthwise.py``);
* ``some_tpu::flash_attention(q, k, v, mask?, scale)`` (K2, ``ops/attention.py``);
* ``some_tpu::splash_attention(q, k, v, mask?, scale)`` (K4; q is pre-scaled
  inside the op, in q's dtype, as :func:`~some_tpu_torch.ops.attention.prescale`
  does it);
* ``some_tpu::fused_ln_ffn_residual(x, ln_scale, ln_bias, w1, b1, w2, b2, eps,
  res_scale)`` (K3, ``ops/fused_ffn.py``).

Each op has two implementations: on a CUDA tensor the wrapper module's own
launch of the hand-written kernel, which counts it in the wrapper's
``launches`` and raises as that launch does (it never runs a plain version
on the card); on a CPU tensor the plain version. Each op's fake
implementation gives the output's shape, dtype and strides without touching
data, so ``torch.export`` records the op by name and a program traced once
runs the kernels wherever it is loaded on the card (``deployment/export.py``).

The ops are defined through ``torch.library.Library`` and registered per
dispatch key, their fakes by :func:`register_fakes` when something traces. ``torch.library.custom_op`` would wrap each implementation in
``torch._disable_dynamo``, whose first call imports ``torch._dynamo``: that
took a fresh infer CLI process's first transcription of a 30 s song from
about 1 s to 12-15 s (NVIDIA H100 80GB HBM3, 700.00 W; torch 2.11), and
added host time to every call. None of the ops has an autograd kernel: the
wrappers call them only where no gradient is needed.

The wrappers (``depthwise_conv1d``, ``flash_attention``, ``splash_attention``,
``fused_ln_ffn_residual``) send every call in which no tensor needs a
gradient through these ops, on either device; a call that needs one keeps its
``autograd.Function`` on the card and the plain autograd on the CPU. Importing
this module registers the ops; the wrappers reach them through
:func:`some_tpu_torch.ops.custom_ops`, which imports it on first use.
"""
from __future__ import annotations

import functools

import torch

from some_tpu_torch.ops import attention as A
from some_tpu_torch.ops import depthwise as W
from some_tpu_torch.ops import fused_ffn as K3

NAMESPACE = "some_tpu"
SCHEMAS = {
    "depthwise_conv1d": "(Tensor x, Tensor w) -> Tensor",
    "flash_attention": "(Tensor q, Tensor k, Tensor v, Tensor? mask, float scale) -> Tensor",
    "splash_attention": "(Tensor q, Tensor k, Tensor v, Tensor? mask, float scale) -> Tensor",
    "fused_ln_ffn_residual": "(Tensor x, Tensor ln_scale, Tensor ln_bias, Tensor w1, Tensor b1, "
                             "Tensor w2, Tensor b2, float eps, float res_scale) -> Tensor",
}


def _bhtd(q, *_):
    """An attention op's output: [B, T, H, D] storage on the card (the kernels
    write there, so the caller's transpose back is free), contiguous
    [B, H, T, D] from the CPU's plain version."""
    if q.device.type == "cuda":
        return A._bhtd_like(q)
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def _like(x, *_):
    """The output of the depthwise conv and of the fused FFN: contiguous, x's shape."""
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


IMPLS = {  # name -> (CPU, CUDA, fake)
    "depthwise_conv1d": (W.depthwise_conv1d_plain,
                         lambda x, w: W._launch(x, w, W.depthwise_conv1d), _like),
    "flash_attention": (A.attention_plain, A._launch, _bhtd),
    "splash_attention": (A.splash_attention_plain,
                         lambda q, k, v, mask, scale: A._splash_forward(
                             A.prescale(q, scale), k, v, mask, A.splash_attention)[0], _bhtd),
    "fused_ln_ffn_residual": (K3.fused_ln_ffn_residual_plain, K3._launch, _like),
}

_LIB = torch.library.Library(NAMESPACE, "DEF")
for _name, _schema in SCHEMAS.items():
    _LIB.define(_name + _schema)
    _LIB.impl(_name, IMPLS[_name][0], "CPU")
    _LIB.impl(_name, IMPLS[_name][1], "CUDA")


@functools.cache
def register_fakes() -> None:
    """Register each op's fake implementation, which tracing needs
    (``torch.export``, ``torch.library.opcheck``) and a forward does not:
    ``deployment/export.py`` calls this before it exports or loads a
    program. Registration is left to then because ``register_fake`` looks
    up its caller's source with ``inspect.getmodule``, which walks every
    loaded module's path on its first call: about 0.5 s of a fresh infer
    CLI process's first transcription of a 30 s song (``bench.cold_file``;
    NVIDIA H100 80GB HBM3, 700.00 W). An op without its fake raises under
    tracing; nothing falls back."""
    for name, (_, _, fake) in IMPLS.items():
        torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
