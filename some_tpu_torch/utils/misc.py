"""Small helpers of the reference's ``utils/__init__.py``.

Counterpart of ``some_tpu/utils/misc.py``, on tensors and numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def tensors_to_scalars(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively turn 0-d tensors and arrays into Python scalars
    (reference: utils/__init__.py:14-22)."""
    out = {}
    for key, value in metrics.items():
        if isinstance(value, dict):
            out[key] = tensors_to_scalars(value)
        elif hasattr(value, "item") and getattr(value, "ndim", 1) == 0:
            out[key] = value.item()
        else:
            out[key] = value
    return out


def remove_padding(x, padding_idx: int = 0):
    """Strip the zero rows of a 2-D or the zero values of a 1-D array or
    tensor (reference: utils/__init__.py:198-205)."""
    if x is None:
        return None
    if x.ndim not in (1, 2):
        raise ValueError(f"want a 1-D or 2-D array, got {x.ndim}-D")
    if x.ndim == 2:
        return x[abs(x).sum(-1) != padding_idx]
    return x[x != padding_idx]


def _leaves(params):
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    if isinstance(params, dict):
        return [leaf for value in params.values() for leaf in _leaves(value)]
    if isinstance(params, (list, tuple)):
        return [leaf for value in params for leaf in _leaves(value)]
    return [params]


def num_params(params, print_out: bool = True, model_name: str = "model") -> float:
    """Parameter count in millions of a module (its parameters) or of a
    state dict, nested or not (every tensor in it)
    (reference: utils/__init__.py:213-218)."""
    count = sum(int(np.prod(leaf.shape)) for leaf in _leaves(params))
    millions = count / 1_000_000
    if print_out:
        print(f"| {model_name} Trainable Parameters: {millions:.3f}M")
    return millions


def print_arch(model, params=None, model_name: str = "model") -> None:
    """Model summary: the module, then its parameter count (of ``params``
    when given) (reference: utils/__init__.py:208-210)."""
    print(f"| {model_name} Arch: ", model)
    if params is not None or isinstance(model, torch.nn.Module):
        num_params(model if params is None else params, model_name=model_name)


def random_continuous_masks(*shape: int, dim: int, rng: np.random.Generator) -> np.ndarray:
    """Random contiguous True spans along ``dim``, drawn from ``rng``
    (reference: utils/__init__.py:37-47; unused upstream, kept for parity)."""
    lohi = np.sort(rng.integers(0, shape[dim] + 1,
                                size=(*shape[:dim], 2, *((1,) * (len(shape) - dim - 1)))),
                   axis=dim)
    start = np.expand_dims(np.take(lohi, 0, axis=dim), dim)
    end = np.expand_dims(np.take(lohi, 1, axis=dim), dim)
    idx = np.arange(shape[dim]).reshape(*((1,) * dim), shape[dim],
                                        *((1,) * (len(shape) - dim - 1)))
    return (idx >= start) & (idx < end)
