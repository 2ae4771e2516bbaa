"""The port's weights into the reference's PyTorch layout (the reverse of ``torch_ckpt.py``).

Counterpart of ``some_tpu/compat/to_torch.py``, written straight from the
port's ``state_dict`` keys. A model trained or served by the port becomes a
Lightning-style ``.ckpt`` for the reference's tools (its own inference, its
ONNX exporter), and the first-party torch model of ``compat/torch_model.py``
(which the ONNX bridge traces) loads these keys strictly. Per key, the
inverse of ``torch_ckpt.py``'s table:

    backbone.in_proj_midi | in_proj_bound     -> model.inln | inln1
    backbone.out_proj | bound_head            -> model.outln | cutheard
    backbone.layer_{i}.midi_block | bound_block -> model.cf_lay.{i}.att1 | att2
    backbone.layer_{i}.midi_gate | bound_gate -> model.cf_lay.{i}.glu1.0 | glu2.0
    backbone.final_midi | final_bound         -> model.att1 | att2

and inside each conformer block ``ffn{1,2}.fc{1,2}`` -> ``ffn{1,2}.ln{1,2}``,
``attn.q_proj | kv_proj | out_proj`` -> ``att.to_q | to_kv | to_out.0``,
``conv.pw{1,2}`` -> ``conv.pointwise_conv{1,2}``, ``conv.dw`` ->
``conv.depthwise_conv``, ``conv.bn`` -> ``conv.norm`` (with a
``num_batches_tracked`` of 0, which torch's BatchNorm carries), ``norm{1..5}``
as they are. Layouts: the port keeps Linear weights as torch does
(``[out, in]``); a pointwise conv gains its kernel axis (``[out, in, 1]``)
and the depthwise taps ``[k, C]`` become ``[C, 1, k]``.
"""
from __future__ import annotations

import pathlib
import re
from typing import Dict

import torch

_SIMPLE = {"in_proj_midi": "inln", "in_proj_bound": "inln1", "out_proj": "outln",
           "bound_head": "cutheard"}
_LAYER = {"midi_block": "att1", "bound_block": "att2", "midi_gate": "glu1.0",
          "bound_gate": "glu2.0"}
_FINAL = {"final_midi": "att1", "final_bound": "att2"}


def _block_key(rest: str, value: torch.Tensor):
    """A conformer-block-relative port key -> (reference key, tensor)."""
    m = re.fullmatch(r"ffn([12])\.fc([12])\.(weight|bias)", rest)
    if m:
        return f"ffn{m.group(1)}.ln{m.group(2)}.{m.group(3)}", value
    m = re.fullmatch(r"attn\.(q_proj|kv_proj|out_proj)\.(weight|bias)", rest)
    if m:
        proj = {"q_proj": "to_q", "kv_proj": "to_kv", "out_proj": "to_out.0"}[m.group(1)]
        return f"att.{proj}.{m.group(2)}", value
    m = re.fullmatch(r"conv\.pw([12])\.(weight|bias)", rest)
    if m:
        return (f"conv.pointwise_conv{m.group(1)}.{m.group(2)}",
                value[:, :, None] if m.group(2) == "weight" else value)
    m = re.fullmatch(r"conv\.dw\.(weight|bias)", rest)
    if m:
        return (f"conv.depthwise_conv.{m.group(1)}",
                value.t()[:, None, :] if m.group(1) == "weight" else value)
    m = re.fullmatch(r"conv\.bn\.(weight|bias|running_mean|running_var)", rest)
    if m:
        return f"conv.norm.{m.group(1)}", value
    m = re.fullmatch(r"norm([1-5])\.(weight|bias)", rest)
    if m:
        return rest, value
    raise KeyError(f"unmapped conformer block key: {rest}")


def backbone_to_torch_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` -> the reference wrapper's (keys ``model.``...),
    float32 and contiguous, on the CPU. Raises ``KeyError`` on a key no rule
    maps (an int8 model's ``weight_scale`` among them: the reference has no
    quantized layout)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        value = value.detach().cpu()
        parts = key.split(".")
        if parts[0] != "backbone" or len(parts) < 3:
            raise KeyError(f"unmapped key: {key}")
        head = parts[1]
        if head in _SIMPLE and len(parts) == 3 and parts[2] in ("weight", "bias"):
            name, tensor = f"{_SIMPLE[head]}.{parts[2]}", value
        elif re.fullmatch(r"layer_\d+", head) and parts[2] in _LAYER:
            prefix = f"cf_lay.{head[len('layer_'):]}.{_LAYER[parts[2]]}"
            if parts[2].endswith("_gate"):
                if len(parts) != 4 or parts[3] not in ("weight", "bias"):
                    raise KeyError(f"unmapped key: {key}")
                name, tensor = f"{prefix}.{parts[3]}", value
            else:
                rest, tensor = _block_key(".".join(parts[3:]), value)
                name = f"{prefix}.{rest}"
        elif head in _FINAL:
            rest, tensor = _block_key(".".join(parts[2:]), value)
            name = f"{_FINAL[head]}.{rest}"
        else:
            raise KeyError(f"unmapped key: {key}")
        if tensor.dtype != torch.float32:
            raise KeyError(f"{key} is {tensor.dtype}: the reference layout holds float32 weights")
        out[f"model.{name}"] = tensor.contiguous()
        if name.endswith("conv.norm.running_mean"):
            out[f"model.{name[:-len('running_mean')]}num_batches_tracked"] = torch.tensor(
                0, dtype=torch.int64)
    return out


def save_torch_checkpoint(state_dict: Dict[str, torch.Tensor], path: pathlib.Path | str) -> None:
    """Write the port's weights as a reference-compatible Lightning-style
    ``.ckpt``: ``{"state_dict": {"model." + key: tensor}}`` over the keys of
    :func:`backbone_to_torch_state_dict` (so ``model.model.inln.weight`` ...)."""
    torch.save({"state_dict": {f"model.{k}": v
                               for k, v in backbone_to_torch_state_dict(state_dict).items()}},
               str(path))
