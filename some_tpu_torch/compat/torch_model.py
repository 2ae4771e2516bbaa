"""First-party PyTorch build of the dual-stream conformer in the reference's key layout.

The port's own copy of ``some_tpu/compat/torch_model.py``, which is pure
torch already. It carries the reference's state-dict key layout (reference:
modules/conform/Gconform.py:20-140, modules/attention/base_attention.py:8-46,
modules/conv/base_conv.py:18-70), so the port's weights, carried across by
``compat/to_torch.py``, load with ``strict=True``. The ONNX bridge
(``deployment/onnx_export.py``) traces it: its grouped ``nn.Conv1d`` for the
depthwise conv and its plain ``scaled_dot_product_attention`` export as the
opset-17 ``Conv`` and ``MatMul``/``Softmax`` nodes downstream runtimes run
well, where the port's own modules hold the hand-written kernels.

An independent copy of the architecture: the port's modules
(``nn/conformer.py``) are held against it in tests/test_torch_onnx.py, and
tests keep their own oracle (tests/torch_oracle.py).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class TorchFFN(nn.Module):
    """dim -> 4*dim -> dim with SiLU (reference: Gconform.py:20-34)."""

    def __init__(self, dim: int):
        super().__init__()
        self.ln1 = nn.Linear(dim, dim * 4)
        self.ln2 = nn.Linear(dim * 4, dim)

    def forward(self, x):
        return self.ln2(F.silu(self.ln1(x)))


class TorchAttention(nn.Module):
    """Bias-free q / fused-kv MHSA (reference: base_attention.py:8-46)."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads = heads
        hidden = heads * dim_head
        self.to_q = nn.Linear(dim, hidden, bias=False)
        self.to_kv = nn.Linear(dim, hidden * 2, bias=False)
        self.to_out = nn.Sequential(nn.Linear(hidden, dim))

    def forward(self, x, mask=None):
        B, T, _ = x.shape
        q = self.to_q(x)
        k, v = self.to_kv(x).chunk(2, dim=2)
        q, k, v = (t.view(B, T, self.heads, -1).transpose(1, 2)
                   for t in (q, k, v))
        attn_mask = mask[:, None, None, :] if mask is not None else None
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)
        out = out.transpose(1, 2).reshape(B, T, -1)
        return self.to_out(out)


class TorchConvModule(nn.Module):
    """pointwise->GLU->depthwise->BN->SiLU->pointwise (reference: base_conv.py:18-70)."""

    def __init__(self, channels: int, kernel_size: int = 31):
        super().__init__()
        self.pointwise_conv1 = nn.Conv1d(channels, 2 * channels, 1)
        self.depthwise_conv = nn.Conv1d(
            channels, channels, kernel_size,
            padding=(kernel_size - 1) // 2, groups=channels)
        self.norm = nn.BatchNorm1d(channels)
        self.pointwise_conv2 = nn.Conv1d(channels, channels, 1)

    def forward(self, x):
        x = x.transpose(1, 2)
        x = F.glu(self.pointwise_conv1(x), dim=1)
        x = self.depthwise_conv(x)
        x = F.silu(self.norm(x))
        x = self.pointwise_conv2(x)
        return x.transpose(1, 2)


class TorchConformerBlock(nn.Module):
    """Macaron conformer block (reference: Gconform.py:37-63)."""

    def __init__(self, dim: int, kernel_size: int = 31, heads: int = 4,
                 dim_head: int = 64):
        super().__init__()
        self.ffn1 = TorchFFN(dim)
        self.ffn2 = TorchFFN(dim)
        self.att = TorchAttention(dim, heads, dim_head)
        self.conv = TorchConvModule(dim, kernel_size)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)
        self.norm4 = nn.LayerNorm(dim)
        self.norm5 = nn.LayerNorm(dim)

    def forward(self, x, mask=None):
        x = self.ffn1(self.norm1(x)) * 0.5 + x
        x = self.att(self.norm2(x), mask=mask) + x
        x = self.conv(self.norm3(x)) + x
        x = self.ffn2(self.norm4(x)) * 0.5 + x
        return self.norm5(x)


class TorchDualStreamBlock(nn.Module):
    """Two conformer streams + GLU cross-injection (reference: Gconform.py:68-87)."""

    def __init__(self, dim: int, kernel_size: int = 31, heads: int = 4,
                 dim_head: int = 64):
        super().__init__()
        self.att1 = TorchConformerBlock(dim, kernel_size, heads, dim_head)
        self.att2 = TorchConformerBlock(dim, kernel_size, heads, dim_head)
        self.glu1 = nn.Sequential(nn.Linear(dim, dim * 2))
        self.glu2 = nn.Sequential(nn.Linear(dim, dim * 2))

    def forward(self, midi, bound):
        midi = self.att1(midi)
        bound = self.att2(bound)
        midi_msg = F.glu(self.glu1(midi), dim=2)
        bound_msg = F.glu(self.glu2(bound), dim=2)
        return midi + bound_msg, bound + midi_msg


class TorchMidiConformer(nn.Module):
    """Backbone: in-projections, N dual-stream layers, heads
    (reference: Gconform.py:92-140)."""

    def __init__(self, lay: int, dim: int, indim: int, outdim: int,
                 kernel_size: int = 31, heads: int = 4, dim_head: int = 64):
        super().__init__()
        self.inln = nn.Linear(indim, dim)
        self.inln1 = nn.Linear(indim, dim)
        self.outln = nn.Linear(dim, outdim)
        self.cutheard = nn.Linear(dim, 1)
        self.cf_lay = nn.ModuleList(
            [TorchDualStreamBlock(dim, kernel_size, heads, dim_head)
             for _ in range(lay)])
        self.att1 = TorchConformerBlock(dim, kernel_size, heads, dim_head)
        self.att2 = TorchConformerBlock(dim, kernel_size, heads, dim_head)

    def forward(self, x, pitch=None, mask=None):
        midi = self.inln(x)
        bound = self.inln1(x)
        if mask is not None:
            midi = midi.masked_fill(~mask.unsqueeze(-1), 0)
        for blk in self.cf_lay:
            midi, bound = blk(midi, bound)
            if mask is not None:
                midi = midi.masked_fill(~mask.unsqueeze(-1), 0)
        midi = self.att1(midi)
        bound = self.att2(bound)
        bound_prob = torch.sigmoid(self.cutheard(bound)).squeeze(-1)
        return self.outln(midi), bound_prob


class TorchMidiExtractor(nn.Module):
    """Wrapper with sig/softmax output flags (reference:
    modules/model/Gmidi_conform.py:22-43). State-dict keys start with
    ``model.``, the layout ``compat/to_torch.py`` emits."""

    def __init__(self, lay: int, dim: int, indim: int, outdim: int,
                 kernel_size: int = 31, heads: int = 4, dim_head: int = 64):
        super().__init__()
        self.model = TorchMidiConformer(
            lay, dim, indim, outdim, kernel_size, heads, dim_head)

    def forward(self, x, f0=None, mask=None, softmax=False, sig=False):
        midi, bound = self.model(x, f0, mask)
        if sig:
            midi = torch.sigmoid(midi)
        if softmax:
            midi = F.softmax(midi, dim=2)
        return midi, bound


def build_torch_extractor(config: dict) -> TorchMidiExtractor:
    """Construct from a SOME config dict (the keys ``nn/model.build_midi_extractor`` reads)."""
    args = config["midi_extractor_args"]
    return TorchMidiExtractor(
        lay=args["lay"], dim=args["dim"],
        indim=config["units_dim"], outdim=config["midi_num_bins"],
        kernel_size=args.get("kernel_size", 31),
        heads=args.get("attention_heads", 4),
        dim_head=args.get("attention_heads_dim", 64),
    )


def load_from_state_dict(config: dict, state_dict) -> TorchMidiExtractor:
    """The port's ``state_dict`` -> a ready-to-run torch model in eval mode,
    through ``compat/to_torch.py`` and a strict ``load_state_dict``."""
    from some_tpu_torch.compat.to_torch import backbone_to_torch_state_dict

    model = build_torch_extractor(config)
    model.load_state_dict(backbone_to_torch_state_dict(state_dict), strict=True)
    model.eval()
    return model
