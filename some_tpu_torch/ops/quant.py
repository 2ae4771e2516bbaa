"""Int8 products of the serving path (``quantize: int8``).

Counterpart of ``some_tpu/ops/quant.py``, with its scheme:

* weights: per output channel, symmetric int8, quantized once at engine load
  on the host in exact f32 numpy (:func:`quantize_weight`); each quantized
  ``QDense`` then holds an int8 ``weight`` buffer ``[out, in]`` and an f32
  ``weight_scale`` buffer ``[out]`` in place of its f32 parameter;
* activations: one dynamic per-tensor scale over the whole tensor, computed
  on the device (:func:`quantize_activation`). The amax covers every row of
  a bucket, padding rows included, as in the JAX package; on a serving mesh
  every replica's shard too (``ops/replica_max.py``: the max over the
  replicas, as GSPMD's all-reduce under the JAX engine's mesh);
* products: int8 x int8 with an int32 accumulator, then one f32 rescale
  ``acc * (sx * sw)`` and a cast to the output dtype (:func:`int8_matmul`).

The JAX package runs the product as an XLA ``dot_general``, not as a Pallas
kernel, so its counterpart here is ``torch._int_mm`` (cuBLASLt on the card;
on CUDA it needs more than 16 rows and K, N multiples of 8, which every
bucket and width of the model meets).

Scope (:func:`quantize_params`): the matmul bulk of the conformer blocks.
The top-level heads and input projections, the depthwise taps and all norms
stay f32.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

# the modules whose weight int8 serving quantizes (some_tpu/ops/quant.py)
_QUANT_LEAF_MODULES = frozenset({
    "fc1", "fc2",                     # FeedForward
    "pw1", "pw2",                     # ConvModule pointwise
    "q_proj", "kv_proj", "out_proj",  # SelfAttention (the block-level out_proj)
    "midi_gate", "bound_gate",        # DualStreamBlock GLU gates
})


def quantize_weight(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """f32 ``[K, N]`` (the JAX layout) -> (int8 ``[K, N]``, f32 scale ``[N]``),
    one scale per output channel."""
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=0)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale[None, :]), -127, 127).astype(np.int8)
    return q, scale


def quantize_activation(x: torch.Tensor, replica=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor symmetric int8: (int8 x, f32 0-d scale). ``round``
    is half to even, as ``jnp.round``. ``replica`` (a mesh replica's
    ``ReplicaMember``) takes the amax over every replica's shard first."""
    xf = x.float()
    amax = xf.abs().amax()
    if replica is not None:
        amax = replica.max(amax)
    sx = torch.clamp(amax / 127.0, min=1e-8)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def int8_matmul(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    """(int8 ``[..., K]``, scale) x (int8 ``[N, K]``, ``[N]``) -> ``[..., N]``
    in ``out_dtype``: int32 accumulation, then ``acc * (sx * sw)`` in f32."""
    lead = xq.shape[:-1]
    acc = torch._int_mm(xq.reshape(-1, xq.shape[-1]), wq.t())
    return (acc.float() * (sx * sw)).to(out_dtype).reshape(*lead, wq.shape[0])


def dynamic_int8_dense(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                       out_dtype: torch.dtype, replica=None) -> torch.Tensor:
    """Quantize ``x`` on the fly (over ``replica``'s group, if given) and run
    the int8 product (no bias)."""
    xq, sx = quantize_activation(x, replica)
    return int8_matmul(xq, sx, wq, sw, out_dtype)


def set_int8_weight(module: nn.Module, q: torch.Tensor, scale: torch.Tensor) -> None:
    """Replace ``module``'s f32 ``weight`` parameter by an int8 ``weight``
    buffer ``[out, in]`` and an f32 ``weight_scale`` buffer ``[out]``."""
    device = module.weight.device
    del module.weight
    module.register_buffer("weight", q.to(device=device, dtype=torch.int8))
    module.register_buffer("weight_scale", scale.to(device=device, dtype=torch.float32))


def quantizable_modules(model: nn.Module) -> Iterator[Tuple[str, nn.Module]]:
    """The (name, module) pairs :func:`quantize_params` quantizes: a linear
    module named in ``_QUANT_LEAF_MODULES`` at depth 3 or more of the module
    tree (``backbone.layer_0.midi_gate``, ``backbone.final_midi.attn.q_proj``,
    ...), whose weight is 2-D. The top-level ``backbone.out_proj`` and
    ``bound_head`` and the input projections are at depth 2."""
    for name, module in model.named_modules():
        path = name.split(".")
        weight = getattr(module, "weight", None)
        if (path[-1] in _QUANT_LEAF_MODULES and len(path) >= 3
                and isinstance(weight, torch.Tensor) and weight.dim() == 2):
            yield name, module


def quantize_params(model: nn.Module) -> int:
    """Quantize every module of :func:`quantizable_modules` in place (its
    weight through :func:`quantize_weight` in the JAX layout, bit for bit
    the JAX package's ``quantize_params``); returns how many."""
    n = 0
    for _, module in quantizable_modules(model):
        if module.weight.dtype == torch.int8:
            continue
        w = module.weight.detach().float().cpu().numpy()  # [out, in]
        q, scale = quantize_weight(w.T)
        set_int8_weight(module, torch.from_numpy(np.ascontiguousarray(q.T)),
                        torch.from_numpy(scale))
        n += 1
    return n


def adopt_int8_layout(model: nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """Give each module whose ``weight`` arrives int8 in ``state_dict`` (a
    quantized checkpoint, or the JAX engine's quantized variables carried
    across) the int8 buffers, so ``load_state_dict`` fills them."""
    eligible = dict(quantizable_modules(model))
    for key, tensor in state_dict.items():
        if tensor.dtype != torch.int8:
            continue
        name = key.rsplit(".", 1)[0]
        if not key.endswith(".weight") or name not in eligible:
            raise KeyError(f"int8 tensor {key} is not the weight of a quantizable module")
        module = eligible[name]
        if module.weight.dtype != torch.int8:
            set_int8_weight(module, torch.zeros_like(tensor),
                            torch.ones(tensor.shape[0], dtype=torch.float32))
