"""Checkpoint files of the port.

The port's own format is ``torch.save`` of ``{"format": FORMAT, "meta": ...,
"state_dict": ...}``, loaded with ``weights_only=True``. A native SOME-TPU
checkpoint (flax msgpack) is read and carried across with
``compat/from_jax.py``. A reference Lightning ``.ckpt`` is a later slice.
"""
from __future__ import annotations

import pathlib
from typing import Dict

import torch

FORMAT = "some-tpu-torch-v1"


def save_checkpoint(path: pathlib.Path | str, state_dict: Dict[str, torch.Tensor],
                    meta: dict | None = None) -> pathlib.Path:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"format": FORMAT, "meta": dict(meta or {}),
               "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()}}
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(payload, tmp)
    tmp.replace(path)
    return path


def load_state_dict(path: pathlib.Path | str) -> Dict[str, torch.Tensor]:
    """The port's state_dict from either checkpoint format."""
    path = pathlib.Path(path)
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"PK":  # a torch zip archive
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(payload, dict) or payload.get("format") != FORMAT:
            raise NotImplementedError(
                f"{path} is a torch checkpoint but not the port's own format; "
                "loading reference Lightning .ckpt files is still to port: see ROADMAP.md")
        return payload["state_dict"]
    from some_tpu_torch.compat.from_jax import jax_params_to_state_dict, read_native_checkpoint

    ckpt = read_native_checkpoint(path)
    return jax_params_to_state_dict(ckpt["params"], ckpt.get("batch_stats") or {})
