"""Plain PyTorch reference of SOME's dual-stream conformer MIDI extractor.

Written from the architecture, not from the program under test: it imports
nothing of the program and none of its kernels. Every product runs in
float32 with TF32 off (``exact_f32``); attention is the textbook masked
softmax; the depthwise convolution is ``F.conv1d`` with one group a channel.
Parameter names follow the checkpoints' layout
(``backbone.layer_0.midi_block.ffn1.fc1.weight``), so one state dict fills
this model and the program alike.

``quant`` fake-quantizes products, with float32 products and rescales:
``"int8"`` (the ``quantize: int8`` configuration) and ``"int4"`` (the
control below it) the products int8 serving quantizes, each weight per
output channel and each input per tensor (one scale over the whole tensor
given), symmetric, rounded half to even; ``"fp8"`` (the control below
bfloat16) every Dense product, weights and inputs scaled the same ways into
float8 e4m3's range and rounded to it.

Training mode (``train=True`` in :meth:`MidiExtractorRef.forward`):
BatchNorm takes the mean and biased variance over the frames ``mask``
marks, and each dropout site multiplies by the keep mask that ``dropout``
returns for (site, shape); the sites are numbered in the model's order
(block by block: ffn1 latent, ffn1 out, attention, conv, ffn2 latent,
ffn2 out).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

#: the products ``quantize: int8`` runs quantized (inside the conformer
#: blocks and the dual-stream gates; not the input projections or heads)
QUANT_LEAVES = ("fc1", "fc2", "pw1", "pw2", "q_proj", "kv_proj", "out_proj",
                "midi_gate", "bound_gate")
DROPOUT_SITES_PER_BLOCK = 6


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32 inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def parameter_shapes(dim: int, lay: int, indim: int, outdim: int, kernel_size: int,
                     heads: int, head_dim: int) -> Iterator[Tuple[str, tuple]]:
    """(name, shape) of every weight, bias and BatchNorm statistic."""
    hidden = heads * head_dim

    def dense(name, n_in, n_out, bias=True):
        yield f"{name}.weight", (n_out, n_in)
        if bias:
            yield f"{name}.bias", (n_out,)

    def norm(name):
        yield f"{name}.weight", (dim,)
        yield f"{name}.bias", (dim,)

    def block(p):
        yield from norm(f"{p}.norm1")
        yield from dense(f"{p}.ffn1.fc1", dim, 4 * dim)
        yield from dense(f"{p}.ffn1.fc2", 4 * dim, dim)
        yield from norm(f"{p}.norm2")
        yield from dense(f"{p}.attn.q_proj", dim, hidden, bias=False)
        yield from dense(f"{p}.attn.kv_proj", dim, 2 * hidden, bias=False)
        yield from dense(f"{p}.attn.out_proj", hidden, dim)
        yield from norm(f"{p}.norm3")
        yield from dense(f"{p}.conv.pw1", dim, 2 * dim)
        yield f"{p}.conv.dw.weight", (kernel_size, dim)
        yield f"{p}.conv.dw.bias", (dim,)
        yield from norm(f"{p}.conv.bn")
        yield f"{p}.conv.bn.running_mean", (dim,)
        yield f"{p}.conv.bn.running_var", (dim,)
        yield from dense(f"{p}.conv.pw2", dim, dim)
        yield from norm(f"{p}.norm4")
        yield from dense(f"{p}.ffn2.fc1", dim, 4 * dim)
        yield from dense(f"{p}.ffn2.fc2", 4 * dim, dim)
        yield from norm(f"{p}.norm5")

    b = "backbone"
    yield from dense(f"{b}.in_proj_midi", indim, dim)
    yield from dense(f"{b}.in_proj_bound", indim, dim)
    for i in range(lay):
        yield from block(f"{b}.layer_{i}.midi_block")
        yield from block(f"{b}.layer_{i}.bound_block")
        yield from dense(f"{b}.layer_{i}.midi_gate", dim, 2 * dim)
        yield from dense(f"{b}.layer_{i}.bound_gate", dim, 2 * dim)
    yield from block(f"{b}.final_midi")
    yield from block(f"{b}.final_bound")
    yield from dense(f"{b}.out_proj", dim, outdim)
    yield from dense(f"{b}.bound_head", dim, 1)


def is_quantized(name: str) -> bool:
    """Whether int8 serving quantizes the weight ``name`` (a 2-D weight of a
    listed product inside the backbone's layers and final blocks)."""
    path = name.split(".")
    return (path[-1] == "weight" and len(path) >= 4 and path[-2] in QUANT_LEAVES
            and path[1] != "out_proj")


QUANT_TOP = {"int8": 127.0, "int4": 7.0, "fp8": 448.0}


def _round_to(x: torch.Tensor, quant: str) -> torch.Tensor:
    top = QUANT_TOP[quant]
    if quant == "fp8":
        return torch.clamp(x, -top, top).to(torch.float8_e4m3fn).float()
    return torch.clamp(torch.round(x), -top, top)


def _straight_through(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``q``'s values, with the gradient of the identity (for training)."""
    return q if not x.requires_grad else x + (q - x).detach()


def fake_quant_weight(w: torch.Tensor, quant: str) -> torch.Tensor:
    """Symmetric per output channel (rows of [out, in])."""
    amax = w.detach().abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / QUANT_TOP[quant], torch.ones_like(amax))
    return _straight_through(w, _round_to(w.detach() / scale, quant) * scale)


def fake_quant_input(x: torch.Tensor, quant: str) -> torch.Tensor:
    """Symmetric per tensor, one scale over all of ``x``."""
    scale = torch.clamp(x.detach().abs().amax() / QUANT_TOP[quant], min=1e-8)
    return _straight_through(x, _round_to(x.detach() / scale, quant) * scale)


class MidiExtractorRef:
    """The reference forward over a state dict of float32 tensors."""

    def __init__(self, state: Dict[str, torch.Tensor], lay: int, heads: int, head_dim: int,
                 quant: Optional[str] = None):
        if quant not in (None, *QUANT_TOP):
            raise ValueError(f"quant {quant!r}: None or one of {sorted(QUANT_TOP)}")
        self.lay, self.heads, self.head_dim = lay, heads, head_dim
        self.quant = quant
        self.p = {}
        for name, t in state.items():
            t = t.float()
            if t.dim() == 2 and self.quantized(name):
                t = fake_quant_weight(t, quant)
            self.p[name] = t

    def quantized(self, name: str) -> bool:
        if self.quant is None or not name.endswith(".weight"):
            return False
        if self.quant == "fp8":
            return ".dw." not in name
        return is_quantized(name)

    # ---- pieces ----
    def dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w = self.p[f"{name}.weight"]
        if self.quantized(f"{name}.weight"):
            x = fake_quant_input(x, self.quant)
        y = x @ w.t()
        bias = self.p.get(f"{name}.bias")
        return y if bias is None else y + bias

    def layer_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                            eps=1e-5)

    def attention(self, p: str, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        B, T, _ = x.shape
        H, D = self.heads, self.head_dim
        q = self.dense(f"{p}.q_proj", x).view(B, T, H, D).transpose(1, 2)
        k, v = self.dense(f"{p}.kv_proj", x).view(B, T, 2, H, D).unbind(2)
        k, v = k.transpose(1, 2), v.transpose(1, 2)
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(D)
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
        out = torch.softmax(scores, dim=-1) @ v
        return self.dense(f"{p}.out_proj", out.transpose(1, 2).reshape(B, T, H * D))

    def batch_norm(self, p: str, x: torch.Tensor, mask: Optional[torch.Tensor],
                   train: bool) -> torch.Tensor:
        if train:
            w = (mask.float()[..., None] if mask is not None
                 else torch.ones(x.shape[:2] + (1,), device=x.device))
            count = torch.clamp(w.sum(), min=1.0)
            mean = (x * w).sum(dim=(0, 1)) / count
            var = (((x - mean) ** 2) * w).sum(dim=(0, 1)) / count
        else:
            mean, var = self.p[f"{p}.running_mean"], self.p[f"{p}.running_var"]
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.p[f"{p}.weight"] + self.p[f"{p}.bias"]

    def conv_module(self, p: str, x, mask, train, drop) -> torch.Tensor:
        out, gate = self.dense(f"{p}.pw1", x).chunk(2, dim=-1)
        x = out * torch.sigmoid(gate)
        if mask is not None:
            x = x * mask[..., None]
        w = self.p[f"{p}.dw.weight"]  # [k, C], a correlation over time
        k = w.shape[0]
        x = F.conv1d(x.transpose(1, 2), w.t()[:, None, :], self.p[f"{p}.dw.bias"],
                     padding=(k - 1) // 2, groups=w.shape[1]).transpose(1, 2)
        x = self.batch_norm(f"{p}.bn", x, mask, train)
        return drop(self.dense(f"{p}.pw2", F.silu(x)))

    def ffn(self, p: str, x, drop_latent, drop_out) -> torch.Tensor:
        return drop_out(self.dense(f"{p}.fc2", drop_latent(F.silu(self.dense(f"{p}.fc1", x)))))

    def block(self, p: str, x, mask, attn_mask, train, site0, dropout) -> torch.Tensor:
        def drop(i):
            if dropout is None:
                return lambda t: t
            return lambda t: t * dropout(site0 + i, t.shape)

        x = x + 0.5 * self.ffn(f"{p}.ffn1", self.layer_norm(f"{p}.norm1", x), drop(0), drop(1))
        x = x + drop(2)(self.attention(f"{p}.attn", self.layer_norm(f"{p}.norm2", x),
                                       attn_mask))
        x = x + self.conv_module(f"{p}.conv", self.layer_norm(f"{p}.norm3", x), mask, train,
                                 drop(3))
        x = x + 0.5 * self.ffn(f"{p}.ffn2", self.layer_norm(f"{p}.norm4", x), drop(4), drop(5))
        return self.layer_norm(f"{p}.norm5", x)

    def glu(self, name: str, x: torch.Tensor) -> torch.Tensor:
        out, gate = self.dense(name, x).chunk(2, dim=-1)
        return out * torch.sigmoid(gate)

    # ---- the model ----
    def forward(self, units: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False,
                dropout: Optional[Callable[[int, tuple], torch.Tensor]] = None):
        """units [B, T, n_mels] -> (midi logits [B, T, bins], boundary
        probabilities [B, T]). ``mask`` [B, T] marks real frames. In training
        each block is recomputed in the backward pass (its activations are
        not kept; the dropout masks and statistics come out the same)."""
        b = "backbone"

        def block(p, x, site):
            if not (train and torch.is_grad_enabled()):
                return self.block(p, x, mask, mask, train, site, dropout)
            from torch.utils.checkpoint import checkpoint

            return checkpoint(lambda y: self.block(p, y, mask, mask, train, site, dropout), x,
                              use_reentrant=False)

        midi = self.dense(f"{b}.in_proj_midi", units)
        bound = self.dense(f"{b}.in_proj_bound", units)
        keep = (lambda t: t) if mask is None else (lambda t: t * mask[..., None])
        midi = keep(midi)
        site = 0
        for i in range(self.lay):
            p = f"{b}.layer_{i}"
            midi = block(f"{p}.midi_block", midi, site)
            site += DROPOUT_SITES_PER_BLOCK
            bound = block(f"{p}.bound_block", bound, site)
            site += DROPOUT_SITES_PER_BLOCK
            midi, bound = (midi + self.glu(f"{p}.bound_gate", bound),
                           bound + self.glu(f"{p}.midi_gate", midi))
            midi = keep(midi)
        midi = block(f"{b}.final_midi", midi, site)
        site += DROPOUT_SITES_PER_BLOCK
        bound = block(f"{b}.final_bound", bound, site)
        logits = self.dense(f"{b}.out_proj", midi)
        bounds = torch.sigmoid(self.dense(f"{b}.bound_head", bound)).squeeze(-1)
        return logits, bounds
