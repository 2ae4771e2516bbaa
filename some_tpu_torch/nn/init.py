"""Torch-style initial weights, drawn as the JAX package draws them.

Counterpart of ``some_tpu/nn/init.py``. ``torch_style_init`` is a copy of
the JAX package's function (numpy only): Dense and depthwise kernels and
their biases uniform in +-1/sqrt(fan_in), norms at scale 1 and bias 0. It
walks the flax ``params`` tree in its dict order, drawing from one numpy
generator, so the order decides the values. :func:`flax_param_tree` builds
that tree for a port model in the order ``MidiExtractor.init`` returns it:
creation order, except that each ``nn.remat``-wrapped layer (``layer_i``
with ``use_remat``) comes back with its keys sorted at every level.
:func:`init_model` carries the drawn tree into the model with
``compat/from_jax.py``, so the port starts from the same weights as the JAX
task's ``init_state`` for the same seed, bit for bit.
"""
from __future__ import annotations

import re
from typing import Any

import numpy as np
from torch import nn

from some_tpu_torch.compat.from_jax import jax_variable_shapes, load_jax_variables

_LAYER = re.compile(r"^layer_\d+$")


def _fan_in(kernel_shape) -> int:
    """Dense [in, out] -> in; depthwise [k, C] -> k."""
    return int(np.prod(kernel_shape[:-1]))


def torch_style_init(params: Any, seed: int = 0) -> Any:
    """Resample kernels and biases of a flax params tree with torch defaults."""
    rng = np.random.default_rng(seed)

    def visit(tree):
        if not isinstance(tree, dict):
            return tree
        out = {}
        kernel = tree.get("kernel")
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = visit(value)
                continue
            arr = np.asarray(value)
            if key == "kernel":
                bound = 1.0 / np.sqrt(max(_fan_in(arr.shape), 1))
                out[key] = rng.uniform(-bound, bound, arr.shape).astype(arr.dtype)
            elif key == "bias" and kernel is not None:
                bound = 1.0 / np.sqrt(max(_fan_in(np.asarray(kernel).shape), 1))
                out[key] = rng.uniform(-bound, bound, arr.shape).astype(arr.dtype)
            else:  # norm scales and biases keep flax's defaults
                out[key] = arr
        return out

    return visit(params)


def _sorted_tree(tree: dict) -> dict:
    return {k: _sorted_tree(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def flax_param_tree(model: nn.Module, remat: bool) -> dict:
    """The flax ``params`` tree of ``model`` at flax's initial values (kernels
    0 as placeholders, norm scales 1, biases 0), in ``init``'s key order."""

    def fill(tree: dict) -> dict:
        out = {}
        for key, sub in tree.items():
            if isinstance(sub, dict):
                node = fill(sub)
                out[key] = _sorted_tree(node) if remat and _LAYER.match(key) else node
            else:
                out[key] = (np.ones if key == "scale" else np.zeros)(sub, np.float32)
        return out

    return fill(jax_variable_shapes(model)["params"])


def init_model(model: nn.Module, seed: int, remat: bool) -> None:
    """Fill ``model`` with ``torch_style_init`` weights for ``seed`` and
    BatchNorm's initial statistics (mean 0, variance 1)."""
    def stat_tree(tree: dict) -> dict:
        return {k: stat_tree(v) if isinstance(v, dict) else
                (np.zeros if k == "mean" else np.ones)(v, np.float32) for k, v in tree.items()}

    stats = stat_tree(jax_variable_shapes(model)["batch_stats"])
    load_jax_variables(model, torch_style_init(flax_param_tree(model, remat), seed), stats)
