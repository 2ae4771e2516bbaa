"""Reference Lightning checkpoints into the port's modules.

Counterpart of ``some_tpu/compat/torch_ckpt.py``, with its own copy of the
key rules. A checkpoint published for the reference implementation is a
Lightning ``.ckpt`` whose ``state_dict`` keys start ``model.`` (the task's
``model``), then ``model.`` again (the backbone inside the wrapper). The
backbone's torch layout (``modules/conform/Gconform.py``) maps onto the flax
tree the port names its modules after:

    inln / inln1                -> backbone.in_proj_midi / in_proj_bound
    outln / cutheard            -> backbone.out_proj / bound_head
    cf_lay.{i}.att1 | att2      -> backbone.layer_{i}.midi_block | bound_block
    cf_lay.{i}.glu1.0 | glu2.0  -> backbone.layer_{i}.midi_gate | bound_gate
    att1 / att2 (top level)     -> backbone.final_midi / final_bound

and inside each conformer block ``ffn{1,2}.ln{1,2}`` -> ``ffn{1,2}.fc{1,2}``,
``att.to_q | to_kv | to_out.0`` -> ``attn.q_proj | kv_proj | out_proj``,
``conv.pointwise_conv{1,2}`` -> ``conv.pw{1,2}``, ``conv.depthwise_conv``
-> ``conv.dw``, ``conv.norm`` -> ``conv.bn`` (its running statistics into
``batch_stats``), ``norm{1..5}`` -> ``norm{1..5}``. Layouts: a Linear
``[out, in]`` becomes the flax ``[in, out]``, a pointwise conv ``[out, in,
1]`` the same, the depthwise conv ``[C, 1, k]`` the flax ``[k, C]``;
``num_batches_tracked`` is dropped. :func:`reference_state_dict` then
carries the tree across with ``compat/from_jax.py``, so each weight reaches
the port in the reference's own layout (Linear ``[out, in]``, the depthwise
taps ``[k, C]``), cast to float32.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from some_tpu_torch.compat.from_jax import jax_params_to_state_dict

_SIMPLE = {"inln": ("in_proj_midi",), "inln1": ("in_proj_bound",),
           "outln": ("out_proj",), "cutheard": ("bound_head",)}


def _set_path(tree: dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _map_block_key(rest: str) -> Optional[Tuple[Tuple[str, ...], str, str]]:
    """A conformer-block-relative torch key -> (path inside the block, leaf,
    kind), None for a key that is dropped; kind is 'linear_w', 'pw_w',
    'dw_w', 'stat' or 'plain'."""
    m = re.match(r"ffn([12])\.ln([12])\.(weight|bias)$", rest)
    if m:
        ffn, fc, leaf = m.groups()
        return ((f"ffn{ffn}", f"fc{fc}"), *(("kernel", "linear_w") if leaf == "weight"
                                            else ("bias", "plain")))
    m = re.match(r"att\.to_(q|kv)\.weight$", rest)
    if m:
        return (("attn", f"{m.group(1)}_proj"), "kernel", "linear_w")
    m = re.match(r"att\.to_out\.0\.(weight|bias)$", rest)
    if m:
        return (("attn", "out_proj"), *(("kernel", "linear_w") if m.group(1) == "weight"
                                        else ("bias", "plain")))
    m = re.match(r"conv\.pointwise_conv([12])\.(weight|bias)$", rest)
    if m:
        idx, leaf = m.groups()
        return (("conv", f"pw{idx}"), *(("kernel", "pw_w") if leaf == "weight"
                                        else ("bias", "plain")))
    m = re.match(r"conv\.depthwise_conv\.(weight|bias)$", rest)
    if m:
        return (("conv", "dw"), *(("kernel", "dw_w") if m.group(1) == "weight"
                                  else ("bias", "plain")))
    m = re.match(r"conv\.norm\.(weight|bias|running_mean|running_var|num_batches_tracked)$",
                 rest)
    if m:
        leaf = {"weight": ("scale", "plain"), "bias": ("bias", "plain"),
                "running_mean": ("mean", "stat"), "running_var": ("var", "stat"),
                "num_batches_tracked": None}[m.group(1)]
        return None if leaf is None else (("conv", "bn"), *leaf)
    m = re.match(r"norm([1-5])\.(weight|bias)$", rest)
    if m:
        idx, leaf = m.groups()
        return ((f"norm{idx}",), "scale" if leaf == "weight" else "bias", "plain")
    raise KeyError(f"unrecognized conformer block key: {rest}")


def convert_backbone_state_dict(state_dict: Dict[str, np.ndarray]) -> dict:
    """The backbone's torch ``state_dict`` (keys ``model.``...) -> the flax
    variables ``{"params", "batch_stats"}`` (numpy); keys outside ``model.``
    are skipped, an unknown key under it raises ``KeyError``."""
    params: dict = {}
    batch_stats: dict = {}
    for key, value in state_dict.items():
        if not key.startswith("model."):
            continue
        rest = key[len("model."):]
        value = np.asarray(value)
        head = rest.split(".", 1)[0]
        if head in _SIMPLE:
            leaf = rest.rsplit(".", 1)[1]
            path = ("backbone",) + _SIMPLE[head]
            _set_path(params, path + (("kernel",) if leaf == "weight" else ("bias",)),
                      value.T if leaf == "weight" else value)
            continue
        m = re.match(r"cf_lay\.(\d+)\.(att1|att2|glu1|glu2)\.(.+)$", rest)
        if m:
            layer_idx, sub, tail = m.groups()
            layer = f"layer_{layer_idx}"
            if sub in ("glu1", "glu2"):
                gate = "midi_gate" if sub == "glu1" else "bound_gate"
                leaf = tail.rsplit(".", 1)[1]  # '0.weight' -> 'weight'
                path = ("backbone", layer, gate)
                _set_path(params, path + (("kernel",) if leaf == "weight" else ("bias",)),
                          value.T if leaf == "weight" else value)
                continue
            prefix = ("backbone", layer, "midi_block" if sub == "att1" else "bound_block")
        else:
            m = re.match(r"(att1|att2)\.(.+)$", rest)
            if not m:
                raise KeyError(f"unrecognized checkpoint key: {key}")
            tail = m.group(2)
            prefix = ("backbone", "final_midi" if m.group(1) == "att1" else "final_bound")
        mapped = _map_block_key(tail)
        if mapped is None:
            continue
        inner, leaf, kind = mapped
        full = prefix + inner + (leaf,)
        if kind == "linear_w":
            _set_path(params, full, value.T)
        elif kind == "pw_w":
            _set_path(params, full, value[:, :, 0].T)  # [out, in, 1] -> [in, out]
        elif kind == "dw_w":
            _set_path(params, full, value[:, 0, :].T)  # [C, 1, k] -> [k, C]
        elif kind == "stat":
            _set_path(batch_stats, full, value)
        else:
            _set_path(params, full, value)
    return {"params": params, "batch_stats": batch_stats}


def reference_state_dict(payload: dict, prefix: str = "model") -> Dict[str, torch.Tensor]:
    """A loaded reference checkpoint (its ``state_dict``, or the dict itself)
    -> the port's ``state_dict``, every leaf float32 (fp16 and bf16 files
    included). Keys outside ``prefix.`` are dropped."""
    state = payload.get("state_dict", payload)
    state = {k[len(prefix) + 1:]: v for k, v in state.items() if k.startswith(f"{prefix}.")}
    arrays = {k: v.detach().cpu().float().numpy() for k, v in state.items()}
    trees = convert_backbone_state_dict(arrays)
    return jax_params_to_state_dict(trees["params"], trees["batch_stats"])
