"""Checkpoint files of the port: the one writer and the one reader.

The port's own format is ``torch.save`` of::

    {"format": FORMAT,
     "meta": {...}  (a training checkpoint: step, micro_step, epoch, epoch_batch),
     "state_dict": the model's (BatchNorm running statistics included),
     "optimizer": the torch optimizer's state_dict, or None,
     "accumulator": {"mini_step", "grads"}, or None}

loaded with ``weights_only=True``. A native SOME-TPU checkpoint (flax
msgpack) is read and carried across with ``compat/from_jax.py``. Any other
torch file, a zip archive or a legacy pickle (the JAX package's test,
``some_tpu/training/checkpoint.py``), is a reference Lightning ``.ckpt``,
carried across with ``compat/torch_ckpt.py``. Lightning pickles objects
that are not tensors (hyper-parameters, callbacks' state), which
``weights_only=True`` refuses, so such a file is loaded with
``weights_only=False``, as the JAX package loads it: that runs the file's
pickle, so load only checkpoints from a source you trust.
"""
from __future__ import annotations

import pathlib
import pickle
from typing import Dict

import torch

FORMAT = "some-tpu-torch-v1"


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: pathlib.Path | str, state_dict: Dict[str, torch.Tensor],
                    meta: dict | None = None, optimizer: dict | None = None,
                    accumulator: dict | None = None) -> pathlib.Path:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"format": FORMAT, "meta": dict(meta or {}), "state_dict": _to_cpu(state_dict),
               "optimizer": _to_cpu(optimizer), "accumulator": _to_cpu(accumulator)}
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(payload, tmp)
    tmp.replace(path)
    return path


def load_checkpoint(path: pathlib.Path | str) -> dict:
    """A port checkpoint as saved; a reference Lightning checkpoint as
    ``{"format": "torch-converted", "meta", "state_dict", "optimizer": None,
    "accumulator": None}``; or a native JAX checkpoint as ``{"format":
    "jax", "meta", "params", "batch_stats", "opt_state"}`` (nested numpy
    dicts, for ``compat/from_jax.py``)."""
    path = pathlib.Path(path)
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic in (b"PK", b"\x80\x02"):  # a torch zip archive, a legacy torch pickle
        try:
            payload = torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError:  # objects beyond tensors: a Lightning file
            payload = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(payload, dict) and payload.get("format") == FORMAT:
            return payload
        from some_tpu_torch.compat.torch_ckpt import reference_state_dict

        return {"format": "torch-converted", "meta": {"step": 0},
                "state_dict": reference_state_dict(payload), "optimizer": None,
                "accumulator": None}
    from some_tpu_torch.compat.from_jax import read_native_checkpoint

    ckpt = read_native_checkpoint(path)
    return {"format": "jax", "meta": ckpt.get("meta") or {}, "params": ckpt["params"],
            "batch_stats": ckpt.get("batch_stats") or {}, "opt_state": ckpt.get("opt_state")}


def load_state_dict(path: pathlib.Path | str) -> Dict[str, torch.Tensor]:
    """The port's state_dict from either checkpoint format."""
    ckpt = load_checkpoint(path)
    if ckpt["format"] != "jax":
        return ckpt["state_dict"]
    from some_tpu_torch.compat.from_jax import jax_params_to_state_dict

    return jax_params_to_state_dict(ckpt["params"], ckpt["batch_stats"])
