"""Model wrapper: backbone + output activation flags.

Counterpart of ``some_tpu/nn/model.py``: ``sig`` applies an f32 sigmoid to
the midi logits, ``softmax`` an f32 softmax over bins; the boundary head is
sigmoided inside the backbone.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from some_tpu_torch.nn.conformer import MidiConformer

# config keys of midi_extractor_args that only training reads
_TRAINING_ONLY = ("use_lay_skip", "conv_drop", "ffn_latent_drop", "ffn_out_drop",
                  "attention_drop")


class MidiExtractor(nn.Module):
    def __init__(self, lay: int, dim: int, indim: int, outdim: int, kernel_size: int = 31,
                 attention_heads: int = 4, attention_heads_dim: int = 64,
                 dtype: torch.dtype = torch.float32, mask_attention: bool = True,
                 attn_impl: str = "auto"):
        super().__init__()
        self.backbone = MidiConformer(
            lay=lay, dim=dim, indim=indim, outdim=outdim, kernel_size=kernel_size,
            attention_heads=attention_heads, attention_heads_dim=attention_heads_dim,
            dtype=dtype, mask_attention=mask_attention, attn_impl=attn_impl)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                softmax: bool = False, sig: bool = False):
        midi, bound = self.backbone(x, mask=mask)
        if sig:
            midi = torch.sigmoid(midi.float())
        if softmax:
            midi = torch.softmax(midi.float(), dim=2)
        return midi, bound


def build_midi_extractor(config: dict, dtype: torch.dtype = torch.float32,
                         mask_attention: bool = True) -> MidiExtractor:
    """The model of a SOME config: ``midi_extractor_args`` plus ``units_dim``,
    ``midi_num_bins`` and ``attention_impl``. The dropout rates and
    ``use_lay_skip`` are training keys and are not read. Opt-in features
    still to be ported raise."""
    if str(config.get("quantize", "none")) != "none":
        raise NotImplementedError("quantize: int8 is still to be ported: see ROADMAP.md")
    if config.get("fuse_ffn", False):
        raise NotImplementedError(
            "fuse_ffn (the JAX package's fused LN->FFN kernel, K3) is still to be "
            "ported: see ROADMAP.md, queue 2")
    args = {k: v for k, v in config["midi_extractor_args"].items()
            if k not in _TRAINING_ONLY + ("indim", "outdim")}
    return MidiExtractor(indim=config["units_dim"], outdim=config["midi_num_bins"],
                         dtype=dtype, mask_attention=mask_attention,
                         attn_impl=config.get("attention_impl", "auto"), **args)
