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

class MidiExtractor(nn.Module):
    def __init__(self, lay: int, dim: int, indim: int, outdim: int, kernel_size: int = 31,
                 attention_heads: int = 4, attention_heads_dim: int = 64,
                 dtype: torch.dtype = torch.float32, mask_attention: bool = True,
                 attn_impl: str = "auto", use_lay_skip: bool = True, conv_drop: float = 0.1,
                 ffn_latent_drop: float = 0.1, ffn_out_drop: float = 0.1,
                 attention_drop: float = 0.1, remat: bool = True,
                 remat_policy: str = "nothing", fuse_ffn: bool = False, quant: str = "none"):
        super().__init__()
        del use_lay_skip  # stored but unused, as in the reference
        self.quant = quant
        self.backbone = MidiConformer(
            lay=lay, dim=dim, indim=indim, outdim=outdim, kernel_size=kernel_size,
            attention_heads=attention_heads, attention_heads_dim=attention_heads_dim,
            dtype=dtype, mask_attention=mask_attention, attn_impl=attn_impl,
            conv_drop=conv_drop, ffn_latent_drop=ffn_latent_drop, ffn_out_drop=ffn_out_drop,
            attention_drop=attention_drop, remat=remat, remat_policy=remat_policy,
            fuse_ffn=fuse_ffn, quant=quant)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                softmax: bool = False, sig: bool = False):
        midi, bound = self.backbone(x, mask=mask)
        if sig:
            midi = torch.sigmoid(midi.float())
        if softmax:
            midi = torch.softmax(midi.float(), dim=2)
        return midi, bound


def build_midi_extractor(config: dict, dtype: torch.dtype = torch.float32,
                         mask_attention: bool = True,
                         quantize: Optional[str] = None) -> MidiExtractor:
    """The model of a SOME config: ``midi_extractor_args`` (the dropout
    rates among them) plus ``units_dim``, ``midi_num_bins``,
    ``attention_impl``, ``use_remat``, ``remat_policy``, ``fuse_ffn`` and
    ``quantize``, which the ``quantize`` argument overrides.

    Int8 is a serving path (``round`` has no gradient), so the training
    tasks pass ``quantize="none"`` even when the work-dir config carries the
    serving key. The weights of an int8 model are quantized after loading
    (``ops/quant.quantize_params``); the inference engine does that."""
    if quantize is None:
        quantize = str(config.get("quantize", "none"))
    args = {k: v for k, v in config["midi_extractor_args"].items()
            if k not in ("indim", "outdim")}
    return MidiExtractor(indim=config["units_dim"], outdim=config["midi_num_bins"],
                         dtype=dtype, mask_attention=mask_attention,
                         attn_impl=config.get("attention_impl", "auto"),
                         remat=bool(config.get("use_remat", True)),
                         remat_policy=str(config.get("remat_policy", "nothing")),
                         fuse_ffn=bool(config.get("fuse_ffn", False)), quant=quantize,
                         **args)
