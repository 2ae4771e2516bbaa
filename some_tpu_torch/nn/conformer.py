"""Dual-stream conformer backbone, eval and train modes.

Counterpart of ``some_tpu/nn/conformer.py``. Module and parameter names
follow the flax tree (``layer_0.midi_block.ffn1.fc1`` ...), so
``some_tpu_torch/compat/from_jax.py`` maps one onto the other leaf by leaf.
Eval mode (``model.eval()``) is the inference path; everything training
adds is gated on ``self.training``:

  * dropout at the JAX sites (the FFN latent and output, the attention
    output, the conv module's output), each mask drawn from a generator
    seeded by (seed, step, site), in an eager step and in a captured one
    alike (see :class:`Dropout`);
  * BatchNorm statistics over the real frames, and the running update;
  * with ``remat``, each dual-stream layer under
    ``torch.utils.checkpoint`` (``nn.remat`` in the JAX package). The
    recompute draws the same dropout masks and does not update the running
    statistics a second time. ``remat_policy`` says what the forward keeps
    for the backward, as the JAX policies do: ``nothing`` (recompute the
    whole layer), ``dots`` (the outputs of the matrix products and
    convolutions: aten ``mm``/``addmm``/``bmm``/``baddbmm``/``convolution``,
    JAX's ``checkpoint_dots``), ``dots_no_batch`` (only the products without
    batch dimensions, ``mm``/``addmm``: every Dense, not the plain
    attention's batched products) and ``save_attn_conv`` (each block's
    attention output after its dropout and the conv module's output, marked
    by :func:`checkpoint_name` as JAX names ``attn_out`` and ``conv_out``).
    The selective policies run through torch's selective checkpoint
    (``create_selective_checkpoint_contexts``), which sees aten ops: the
    hand-written kernels (K1, K2, K4) launch through ``ctypes`` inside
    ``autograd.Function``s, so no policy saves their outputs and every
    policy runs their forwards again in the recompute, as no JAX policy
    saves a ``pallas_call``'s outputs;

Parameters stay float32; computation runs in ``dtype`` with the JAX
package's precision contract:
  * each Dense casts its input and weight to ``dtype`` before the matmul
    and adds the bias in ``dtype``;
  * LayerNorm takes its statistics in f32 (flax's E[x^2] - E[x]^2) and
    returns ``dtype``;
  * BatchNorm (running stats) and the SiLU after it run in f32, then cast;
  * attention scores and softmax are f32 (see ops/attention.py);
  * the boundary sigmoid is f32.

With ``fuse_ffn`` (inference only, as in JAX) each macaron FFN of an
eval-mode block is one fused LN -> FFN -> residual kernel
(``ops/fused_ffn.py``), with that kernel's arithmetic (f32 biases and SiLU,
the JAX kernel's LayerNorm variance); training runs the unfused modules.

With ``quant='int8'`` (serving only) the model runs the int8 products of
``ops/quant.py`` wherever ``quantize_params`` gave a ``QDense`` int8
weights: each such Dense quantizes its input per tensor, except that the
attention's q and kv projections share one quantization of their input. A
quantized model never fuses its FFNs (K3 reads f32 weights), as in JAX. On
a serving mesh each int8 site takes its scale over every replica's shard
(:func:`set_replica_member`, ``ops/replica_max.py``).

Masks: attention excludes padded keys, the conv module zeroes padded frames
before the depthwise conv, and MidiConformer re-masks the midi stream after
its input projection and after every layer. With them a padded bucket
reproduces the unpadded sequence.

Each kernel-backed module has a test-only ``impl`` switch ('auto' | 'plain',
see :func:`set_kernel_impl`) that forces the kernels' plain versions on the
card, for comparing the two; no config key reads it.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from some_tpu_torch.ops.attention import attention_bhtd
from some_tpu_torch.ops.depthwise import depthwise_conv1d
from some_tpu_torch.ops.fused_ffn import fused_ln_ffn_residual
from some_tpu_torch.ops.quant import dynamic_int8_dense, int8_matmul, quantize_activation


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _glu(x: torch.Tensor) -> torch.Tensor:
    out, gate = x.chunk(2, dim=-1)
    return out * torch.sigmoid(gate)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale what is kept
    by 1 / (1 - rate). The mask comes from a generator seeded with the key of
    the seed and step of :func:`set_dropout_step` and the module's ``site``
    (its index among the model's dropouts), the counterpart of the JAX
    package's ``fold_in(base_rng, step)``: no global RNG state is read. The
    bits differ from JAX's.

    Each module keeps one generator a draw of a step (``DRAWS``: the
    forward's, and the remat recompute's, which so draws the forward's
    mask). An eager forward seeds the draw's generator itself. A captured
    step cannot seed inside the capture: the task registers the generators
    with its graphs (:func:`dropout_generators`) and seeds them with the
    step's keys before each replay (:func:`seed_dropout`), so each
    generator draws once a replay from the offset 0 of its key, as the
    eager forward does."""

    #: draws of a step: the forward, and the recompute of a remat'd layer
    DRAWS = 2

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.site = 0
        self.seed_step = None
        #: (first row, global rows): this process's rows of the global batch
        self.rows = None
        #: draws since set_dropout_step
        self.draws = 0
        self._generators: list = []
        self._generator_device = None

    def key(self) -> int:
        seed, step = self.seed_step
        return ((seed * 1_000_003 + step) * 10_007 + self.site) % (1 << 63)

    def generators(self, device: torch.device) -> list:
        """The module's generators on ``device``, one a draw, made on first use."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self._generator_device != device:
            self._generators = [torch.Generator(device=device) for _ in range(self.DRAWS)]
            self._generator_device = device
        return self._generators

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.seed_step is None:
            raise RuntimeError("a training forward needs set_dropout_step(model, seed, step)")
        draw = self.draws
        self.draws += 1
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            if draw >= self.DRAWS:  # a generator draws once a replay
                raise RuntimeError(f"dropout site {self.site} drew {draw + 1} masks in one "
                                   f"captured step, at most {self.DRAWS} (the forward and a "
                                   "remat recompute)")
            gen = self.generators(x.device)[draw]
        else:
            gen = self.generators(x.device)[draw % self.DRAWS]
            gen.manual_seed(self.key())
        keep_prob = 1.0 - self.rate
        if self.rows is None:
            keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
        else:  # the global batch's mask, this process's rows of it
            first, total = self.rows
            keep = torch.rand((total, *x.shape[1:]), generator=gen, device=x.device)
            keep = keep[first:first + x.shape[0]] < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def _dropouts(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, Dropout)]


def set_dropout_step(model: nn.Module, seed: int, step: int, rows=None) -> None:
    """Number the model's dropouts and key their masks to (seed, step);
    ``rows`` = (first row, global rows) when this process holds part of a
    global batch, so the masks are the one-process run's."""
    for site, module in enumerate(_dropouts(model)):
        module.site = site
        module.seed_step = (int(seed), int(step))
        module.rows = rows
        module.draws = 0


def dropout_generators(model: nn.Module) -> list:
    """Every generator the model's dropouts draw from on the model's device:
    what a captured train step registers with its graph."""
    device = next(model.parameters()).device
    return [g for m in _dropouts(model) if m.rate > 0.0 for g in m.generators(device)]


def seed_dropout(model: nn.Module) -> None:
    """Seed each dropout's generators with its key of the step that
    :func:`set_dropout_step` set: before a captured step's replay."""
    for module in _dropouts(model):
        if module.rate > 0.0:
            for gen in module._generators:
                gen.manual_seed(module.key())


@functools.lru_cache(maxsize=None)
def _checkpoint_name_op():
    """``some_tpu_torch::checkpoint_name``, registered on first use: a copy of
    its input (a registered op returns no alias of its input), whose
    gradient passes through. It marks a tensor for ``save_attn_conv``."""
    @torch.library.custom_op("some_tpu_torch::checkpoint_name", mutates_args=())
    def checkpoint_name_op(x: torch.Tensor, name: str) -> torch.Tensor:
        return x.clone()

    @checkpoint_name_op.register_fake
    def _(x, name):
        return torch.empty_like(x)

    checkpoint_name_op.register_autograd(lambda ctx, grad: (grad, None))
    return checkpoint_name_op


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``jax.ad_checkpoint.checkpoint_name``: the same values, as an op the
    ``save_attn_conv`` policy saves."""
    return _checkpoint_name_op()(x, name)


REMAT_POLICIES = ("nothing", "dots", "dots_no_batch", "save_attn_conv")


def _saved_ops(policy: str):
    aten = torch.ops.aten
    if policy == "dots":
        return {aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution}
    if policy == "dots_no_batch":
        return {aten.mm, aten.addmm}
    _checkpoint_name_op()
    return {torch.ops.some_tpu_torch.checkpoint_name}


def _selective_contexts(policy: str):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a selective
    policy: the ops it names are kept, all others recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    saved = _saved_ops(policy)

    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return create_selective_checkpoint_contexts(policy_fn)


class QDense(nn.Linear):
    """Linear in ``dtype``, with the JAX QDense's int8 serving path: once
    ``ops/quant.quantize_params`` has replaced the weight by an int8 buffer
    and its per-channel ``weight_scale``, the input is quantized on the fly
    and the product runs int8 x int8 -> int32. The bias is added in
    ``dtype`` either way. ``replica``: see :func:`set_replica_member`."""

    replica = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    @property
    def is_int8(self) -> bool:
        return self.weight.dtype == torch.int8

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.is_int8:
            y = dynamic_int8_dense(x, self.weight, self.weight_scale, dt, self.replica)
        else:
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
    """dim -> 4*dim -> dim with SiLU, dropout on the latent and the output."""

    def __init__(self, dim: int, dtype: torch.dtype, latent_drop: float = 0.0,
                 out_drop: float = 0.0):
        super().__init__()
        self.fc1 = QDense(dim, dim * 4, dtype=dtype)
        self.latent_drop = Dropout(latent_drop)
        self.fc2 = QDense(dim * 4, dim, dtype=dtype)
        self.out_drop = Dropout(out_drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_drop(self.fc2(self.latent_drop(_silu(self.fc1(x)))))


class SelfAttention(nn.Module):
    """Bias-free q / fused-kv MHSA. The projections' [B, T, H, D] outputs go
    to the attention as [B, H, T, D] strided views, and its output comes back
    in [B, T, H, D] storage, so neither side copies."""

    replica = None

    def __init__(self, dim: int, heads: int, head_dim: int, dtype: torch.dtype,
                 attn_impl: str = "auto"):
        super().__init__()
        hidden = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.attn_impl = attn_impl
        self.impl = "auto"
        self.compute_dtype = dtype
        self.q_proj = QDense(dim, hidden, bias=False, dtype=dtype)
        self.kv_proj = QDense(dim, hidden * 2, bias=False, dtype=dtype)
        self.out_proj = QDense(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, _ = x.shape
        H, D = self.heads, self.head_dim
        if self.q_proj.is_int8:
            # one dynamic quantization of x, shared by q and kv (as in JAX)
            xq, sx = quantize_activation(x, self.replica)
            q = int8_matmul(xq, sx, self.q_proj.weight, self.q_proj.weight_scale,
                            self.compute_dtype)
            kv = int8_matmul(xq, sx, self.kv_proj.weight, self.kv_proj.weight_scale,
                             self.compute_dtype)
        else:
            q, kv = self.q_proj(x), self.kv_proj(x)
        q = q.unflatten(-1, (H, D)).transpose(1, 2)
        k, v = kv.chunk(2, dim=-1)
        k = k.unflatten(-1, (H, D)).transpose(1, 2)
        v = v.unflatten(-1, (H, D)).transpose(1, 2)
        out = attention_bhtd(q, k, v, mask, D ** -0.5, self.attn_impl, self.impl)
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
    """BatchNorm over (batch, time), in f32. Eval: the running statistics.
    Train: the mean and the biased variance over the frames ``mask`` marks
    real (all frames without a mask), and the running update in flax's
    convention, ``ra = 0.9 ra + 0.1 new``, with the unbiased variance, as
    the JAX ``MaskedBatchNorm`` does; not again in a remat recompute. With
    ``sync_stats`` (several processes, see :func:`set_sync_batch_stats`) the
    counts and sums are summed over the processes, so the statistics are the
    global batch's, as under the JAX package's GSPMD."""

    MOMENTUM = 0.9

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.eps = eps
        #: set while torch.utils.checkpoint recomputes the layer (see _Recompute)
        self.recomputing = False
        self.sync_stats = False

    def _global_stats(self, xf: torch.Tensor, mask: Optional[torch.Tensor]):
        """(count, mean, biased var) over every process's real frames."""
        from some_tpu_torch.parallel.distributed import all_sum, all_sum_grad

        w = (mask.float()[..., None] if mask is not None
             else torch.ones(xf.shape[:2] + (1,), device=xf.device))
        count = torch.clamp(all_sum(w.sum()), min=1.0)
        mean = all_sum_grad((xf * w).sum(dim=(0, 1))) / count
        var = all_sum_grad((((xf - mean) ** 2) * w).sum(dim=(0, 1))) / count
        return count, mean, var

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            if self.sync_stats:
                count, mean, var = self._global_stats(xf, mask)
            elif mask is not None:
                w = mask.float()[..., None]
                count = torch.clamp(w.sum(), min=1.0)
                mean = (xf * w).sum(dim=(0, 1)) / count
                var = (((xf - mean) ** 2) * w).sum(dim=(0, 1)) / count
            else:  # a fill, not a copy from the host: it can be captured
                count = torch.full((), float(xf.shape[0] * xf.shape[1]), device=x.device)
                mean = xf.mean(dim=(0, 1))
                var = xf.var(dim=(0, 1), unbiased=False)
            if not self.recomputing:
                with torch.no_grad():
                    var_unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
                    m = self.MOMENTUM
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1 - m) * var_unbiased)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


class ConvModule(nn.Module):
    """pointwise -> GLU -> mask -> depthwise -> BN -> SiLU -> pointwise."""

    def __init__(self, dim: int, kernel_size: int, dtype: torch.dtype, drop: float = 0.0):
        super().__init__()
        self.compute_dtype = dtype
        self.pw1 = QDense(dim, 2 * dim, dtype=dtype)
        self.dw = DepthwiseConv1d(dim, kernel_size, dtype)
        self.bn = MaskedBatchNorm(dim)
        self.pw2 = QDense(dim, dim, dtype=dtype)
        self.drop = Dropout(drop)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = _glu(self.pw1(x))
        if mask is not None:
            # padded frames become exact zeros, the implicit zero padding the
            # depthwise conv sees on an unpadded sequence
            x = torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        x = self.bn(self.dw(x), mask)
        return self.drop(self.pw2(_silu(x).to(self.compute_dtype)))


class ConformerBlock(nn.Module):
    """Macaron block: x0.5 FFN -> MHSA -> conv module -> x0.5 FFN -> LN."""

    def __init__(self, dim: int, kernel_size: int, heads: int, head_dim: int,
                 dtype: torch.dtype, attn_impl: str = "auto", conv_drop: float = 0.0,
                 ffn_latent_drop: float = 0.0, ffn_out_drop: float = 0.0,
                 attention_drop: float = 0.0, fuse_ffn: bool = False, quant: str = "none"):
        super().__init__()
        self.fuse_ffn = fuse_ffn
        self.quant = quant
        self.ffn_impl = "auto"
        #: mark attn_out / conv_out for save_attn_conv (the remat'd layers' blocks)
        self.checkpoint_names = False
        self.norm1 = LayerNorm(dim, dtype)
        self.ffn1 = FeedForward(dim, dtype, ffn_latent_drop, ffn_out_drop)
        self.norm2 = LayerNorm(dim, dtype)
        self.attn = SelfAttention(dim, heads, head_dim, dtype, attn_impl)
        self.attn_drop = Dropout(attention_drop)
        self.norm3 = LayerNorm(dim, dtype)
        self.conv = ConvModule(dim, kernel_size, dtype, conv_drop)
        self.norm4 = LayerNorm(dim, dtype)
        self.ffn2 = FeedForward(dim, dtype, ffn_latent_drop, ffn_out_drop)
        self.norm5 = LayerNorm(dim, dtype)

    def _macaron_ffn(self, x: torch.Tensor, norm: LayerNorm, ffn: FeedForward) -> torch.Tensor:
        """x + 0.5 * FFN(LN(x)): the fused kernel with the block's own weights
        when ``fuse_ffn``, in eval mode and unquantized (the JAX
        ``_macaron_ffn``), else the unfused modules, dropout included."""
        if self.fuse_ffn and not self.training and self.quant == "none":
            return fused_ln_ffn_residual(x, norm.weight, norm.bias, ffn.fc1.weight.t(),
                                         ffn.fc1.bias, ffn.fc2.weight.t(), ffn.fc2.bias,
                                         eps=norm.eps, res_scale=0.5, impl=self.ffn_impl)
        return ffn(norm(x)) * 0.5 + x

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        name = self.checkpoint_names and self.training and torch.is_grad_enabled()
        x = self._macaron_ffn(x, self.norm1, self.ffn1)
        att = self.attn_drop(self.attn(self.norm2(x), mask))
        x = (checkpoint_name(att, "attn_out") if name else att) + x
        cv = self.conv(self.norm3(x), mask)
        x = (checkpoint_name(cv, "conv_out") if name else cv) + x
        x = self._macaron_ffn(x, self.norm4, self.ffn2)
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


def set_sync_batch_stats(model: nn.Module, sync: bool) -> None:
    """Take every BatchNorm's training statistics over all processes."""
    for module in model.modules():
        if isinstance(module, MaskedBatchNorm):
            module.sync_stats = sync


def set_replica_member(model: nn.Module, member) -> None:
    """Give every int8 site of ``model`` (each ``QDense`` and the attention's
    shared q/kv quantization) a serving mesh replica's ``ReplicaMember``
    (``ops/replica_max.py``), whose group takes each site's amax over every
    replica's shard; None takes it over this model's input alone."""
    for module in model.modules():
        if isinstance(module, (QDense, SelfAttention)):
            module.replica = member


def set_kernel_impl(model: nn.Module, impl: str) -> None:
    """Set the test-only ``impl`` switch of every kernel-backed module:
    'plain' runs the kernels' plain versions on any device (to compare them
    with the kernels on the card), 'auto' the kernels on a CUDA tensor."""
    for module in model.modules():
        if isinstance(module, (DepthwiseConv1d, SelfAttention)):
            module.impl = impl
        elif isinstance(module, ConformerBlock):
            module.ffn_impl = impl


class _Recompute:
    """The function torch.utils.checkpoint runs for one layer: its first
    call is the forward, any later call the recompute in the backward, run
    with the layer's BatchNorms marked ``recomputing``."""

    def __init__(self, layer: nn.Module):
        self.layer = layer
        self.calls = 0

    def __call__(self, *args):
        self.calls += 1
        if self.calls == 1:
            return self.layer(*args)
        norms = [m for m in self.layer.modules() if isinstance(m, MaskedBatchNorm)]
        for m in norms:
            m.recomputing = True
        try:
            return self.layer(*args)
        finally:
            for m in norms:
                m.recomputing = False


class MidiConformer(nn.Module):
    """In-projections, ``lay`` dual-stream layers, a final block per stream,
    the midi head and the sigmoid boundary head.

    Returns (midi_logits [B, T, outdim] in dtype, bound_prob [B, T] f32)."""

    def __init__(self, lay: int, dim: int, indim: int, outdim: int, kernel_size: int = 31,
                 attention_heads: int = 4, attention_heads_dim: int = 64,
                 dtype: torch.dtype = torch.float32, mask_attention: bool = True,
                 attn_impl: str = "auto", conv_drop: float = 0.0, ffn_latent_drop: float = 0.0,
                 ffn_out_drop: float = 0.0, attention_drop: float = 0.0, remat: bool = True,
                 remat_policy: str = "nothing", fuse_ffn: bool = False, quant: str = "none"):
        super().__init__()
        if quant not in ("none", "int8"):
            raise ValueError(f"quantize {quant!r}: 'none' or 'int8'")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r}: one of {REMAT_POLICIES}")
        self.lay = lay
        self.mask_attention = mask_attention
        self.compute_dtype = dtype
        self.remat = remat
        self.remat_policy = remat_policy
        block_args = dict(kernel_size=kernel_size, heads=attention_heads,
                          head_dim=attention_heads_dim, attn_impl=attn_impl,
                          conv_drop=conv_drop, ffn_latent_drop=ffn_latent_drop,
                          ffn_out_drop=ffn_out_drop, attention_drop=attention_drop,
                          fuse_ffn=fuse_ffn, quant=quant)
        self.in_proj_midi = QDense(indim, dim, dtype=dtype)
        self.in_proj_bound = QDense(indim, dim, dtype=dtype)
        for i in range(lay):
            layer = DualStreamBlock(dim, dtype, **block_args)
            for block in (layer.midi_block, layer.bound_block):
                block.checkpoint_names = remat and remat_policy == "save_attn_conv"
            self.add_module(f"layer_{i}", layer)
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
        remat = self.remat and self.training and torch.is_grad_enabled()
        selective = {}
        if self.remat_policy != "nothing":
            selective["context_fn"] = functools.partial(_selective_contexts, self.remat_policy)
        for i in range(self.lay):
            layer = getattr(self, f"layer_{i}")
            if remat:
                midi, bound = checkpoint(_Recompute(layer), midi, bound, mask,
                                         use_reentrant=False, **selective)
            else:
                midi, bound = layer(midi, bound, mask)
            if mask is not None:
                midi = torch.where(mask[..., None], midi, zero)
        midi = self.final_midi(midi, attn_mask)
        bound = self.final_bound(bound, attn_mask)
        midi_logits = self.out_proj(midi)
        bound_prob = torch.sigmoid(self.bound_head(bound).float()).squeeze(-1)
        return midi_logits, bound_prob
