"""Dual-stream conformer backbone, inference (eval) path.

Counterpart of ``some_tpu/nn/conformer.py``. Module and parameter names
follow the flax tree (``layer_0.midi_block.ffn1.fc1`` ...), so
``some_tpu_torch/compat/from_jax.py`` maps one onto the other leaf by leaf.
Dropout is inference-off and not built.

Parameters stay float32; computation runs in ``dtype`` with the JAX
package's precision contract:
  * each Dense casts its input and weight to ``dtype`` before the matmul
    and adds the bias in ``dtype``;
  * LayerNorm takes its statistics in f32 (flax's E[x^2] - E[x]^2) and
    returns ``dtype``;
  * BatchNorm (running stats) and the SiLU after it run in f32, then cast;
  * attention scores and softmax are f32 (see ops/attention.py);
  * the boundary sigmoid is f32.

Masks: attention excludes padded keys, the conv module zeroes padded frames
before the depthwise conv, and MidiConformer re-masks the midi stream after
its input projection and after every layer. With them a padded bucket
reproduces the unpadded sequence.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from some_tpu_torch.ops.attention import attention_bhtd
from some_tpu_torch.ops.depthwise import depthwise_conv1d


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _glu(x: torch.Tensor) -> torch.Tensor:
    out, gate = x.chunk(2, dim=-1)
    return out * torch.sigmoid(gate)


class QDense(nn.Linear):
    """Linear in ``dtype`` (the JAX QDense without its int8 path)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-5, dtype=dtype)``: f32 statistics
    (variance as E[x^2] - E[x]^2, clamped at 0), output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(self.compute_dtype)


class FeedForward(nn.Module):
    """dim -> 4*dim -> dim with SiLU."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = QDense(dim, dim * 4, dtype=dtype)
        self.fc2 = QDense(dim * 4, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(_silu(self.fc1(x)))


class SelfAttention(nn.Module):
    """Bias-free q / fused-kv MHSA. The projections' [B, T, H, D] outputs go
    to the attention as [B, H, T, D] strided views, and its output comes back
    in [B, T, H, D] storage, so neither side copies."""

    def __init__(self, dim: int, heads: int, head_dim: int, dtype: torch.dtype,
                 attn_impl: str = "auto"):
        super().__init__()
        hidden = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.attn_impl = attn_impl
        self.compute_dtype = dtype
        self.q_proj = QDense(dim, hidden, bias=False, dtype=dtype)
        self.kv_proj = QDense(dim, hidden * 2, bias=False, dtype=dtype)
        self.out_proj = QDense(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, _ = x.shape
        H, D = self.heads, self.head_dim
        q = self.q_proj(x).unflatten(-1, (H, D)).transpose(1, 2)
        k, v = self.kv_proj(x).chunk(2, dim=-1)
        k = k.unflatten(-1, (H, D)).transpose(1, 2)
        v = v.unflatten(-1, (H, D)).transpose(1, 2)
        out = attention_bhtd(q, k, v, mask, D ** -0.5, self.attn_impl)
        out = out.transpose(1, 2).reshape(B, T, H * D).to(self.compute_dtype)
        return self.out_proj(out)


class DepthwiseConv1d(nn.Module):
    """Per-channel temporal conv, weight stored as [k, C] like the JAX
    kernel. ``impl``: 'auto' (the CUDA kernel on a CUDA tensor) or 'plain'."""

    def __init__(self, channels: int, kernel_size: int, dtype: torch.dtype,
                 impl: str = "auto"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(kernel_size, channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        nn.init.normal_(self.weight, std=kernel_size ** -0.5)
        self.compute_dtype = dtype
        self.impl = impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = depthwise_conv1d(x.to(dt), self.weight.to(dt), self.impl)
        return y + self.bias.to(dt)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over (batch, time) in eval mode: the running stats, an f32
    elementwise affine. Training statistics come with the training slice."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = (x.float() - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return y * self.weight + self.bias


class ConvModule(nn.Module):
    """pointwise -> GLU -> mask -> depthwise -> BN -> SiLU -> pointwise."""

    def __init__(self, dim: int, kernel_size: int, dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = dtype
        self.pw1 = QDense(dim, 2 * dim, dtype=dtype)
        self.dw = DepthwiseConv1d(dim, kernel_size, dtype)
        self.bn = MaskedBatchNorm(dim)
        self.pw2 = QDense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = _glu(self.pw1(x))
        if mask is not None:
            # padded frames become exact zeros, the implicit zero padding the
            # depthwise conv sees on an unpadded sequence
            x = torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        x = self.bn(self.dw(x))
        return self.pw2(_silu(x).to(self.compute_dtype))


class ConformerBlock(nn.Module):
    """Macaron block: x0.5 FFN -> MHSA -> conv module -> x0.5 FFN -> LN."""

    def __init__(self, dim: int, kernel_size: int, heads: int, head_dim: int,
                 dtype: torch.dtype, attn_impl: str = "auto"):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.ffn1 = FeedForward(dim, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.attn = SelfAttention(dim, heads, head_dim, dtype, attn_impl)
        self.norm3 = LayerNorm(dim, dtype)
        self.conv = ConvModule(dim, kernel_size, dtype)
        self.norm4 = LayerNorm(dim, dtype)
        self.ffn2 = FeedForward(dim, dtype)
        self.norm5 = LayerNorm(dim, dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.ffn1(self.norm1(x)) * 0.5 + x
        x = self.attn(self.norm2(x), mask) + x
        x = self.conv(self.norm3(x), mask) + x
        x = self.ffn2(self.norm4(x)) * 0.5 + x
        return self.norm5(x)


class DualStreamBlock(nn.Module):
    """Two conformer streams cross-injected through per-stream GLU gates."""

    def __init__(self, dim: int, dtype: torch.dtype, **block_args):
        super().__init__()
        self.midi_block = ConformerBlock(dim, dtype=dtype, **block_args)
        self.bound_block = ConformerBlock(dim, dtype=dtype, **block_args)
        self.midi_gate = QDense(dim, dim * 2, dtype=dtype)
        self.bound_gate = QDense(dim, dim * 2, dtype=dtype)

    def forward(self, midi, bound, mask: Optional[torch.Tensor] = None):
        midi = self.midi_block(midi, mask)
        bound = self.bound_block(bound, mask)
        midi_msg = _glu(self.midi_gate(midi))
        bound_msg = _glu(self.bound_gate(bound))
        return midi + bound_msg, bound + midi_msg


class MidiConformer(nn.Module):
    """In-projections, ``lay`` dual-stream layers, a final block per stream,
    the midi head and the sigmoid boundary head.

    Returns (midi_logits [B, T, outdim] in dtype, bound_prob [B, T] f32)."""

    def __init__(self, lay: int, dim: int, indim: int, outdim: int, kernel_size: int = 31,
                 attention_heads: int = 4, attention_heads_dim: int = 64,
                 dtype: torch.dtype = torch.float32, mask_attention: bool = True,
                 attn_impl: str = "auto"):
        super().__init__()
        self.lay = lay
        self.mask_attention = mask_attention
        self.compute_dtype = dtype
        block_args = dict(kernel_size=kernel_size, heads=attention_heads,
                          head_dim=attention_heads_dim, attn_impl=attn_impl)
        self.in_proj_midi = QDense(indim, dim, dtype=dtype)
        self.in_proj_bound = QDense(indim, dim, dtype=dtype)
        for i in range(lay):
            self.add_module(f"layer_{i}", DualStreamBlock(dim, dtype, **block_args))
        self.final_midi = ConformerBlock(dim, dtype=dtype, **block_args)
        self.final_bound = ConformerBlock(dim, dtype=dtype, **block_args)
        self.out_proj = QDense(dim, outdim, dtype=dtype)
        self.bound_head = QDense(dim, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        attn_mask = mask if (self.mask_attention and mask is not None) else None
        x = x.to(self.compute_dtype)
        midi = self.in_proj_midi(x)
        bound = self.in_proj_bound(x)
        zero = torch.zeros((), dtype=midi.dtype, device=midi.device)
        if mask is not None:
            midi = torch.where(mask[..., None], midi, zero)
        # the dual-stream layers take `mask` and the final blocks `attn_mask`,
        # as in the JAX package
        for i in range(self.lay):
            midi, bound = getattr(self, f"layer_{i}")(midi, bound, mask)
            if mask is not None:
                midi = torch.where(mask[..., None], midi, zero)
        midi = self.final_midi(midi, attn_mask)
        bound = self.final_bound(bound, attn_mask)
        midi_logits = self.out_proj(midi)
        bound_prob = torch.sigmoid(self.bound_head(bound).float()).squeeze(-1)
        return midi_logits, bound_prob
