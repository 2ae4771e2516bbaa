"""Initial weights: torch-style, drawn as the JAX package draws them, or
flax's own initializers.

Counterpart of ``some_tpu/nn/init.py`` and of the flax defaults the JAX
modules name (``some_tpu/nn/conformer.py``). ``torch_style_init`` is a copy of
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

With ``torch_style_init: false`` the JAX task keeps flax's initializers:
every Dense, attention projection and depthwise kernel ``lecun_normal``
(a normal truncated at two standard deviations, scaled to variance
1/fan_in, fan_in the kernel's input axis: ``in`` of a Dense ``[in, out]``,
the taps ``k`` of the depthwise ``[k, C]``), every bias 0, every LayerNorm
and BatchNorm scale 1. :func:`flax_default_init` draws the same
distributions from a ``torch.Generator`` seeded by ``seed``; the values
differ from JAX's, whose draws come from ``jax.random``'s threefry.
"""
from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch
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


# the standard deviation of a standard normal truncated to [-2, 2] (flax's
# variance_scaling divides by it so the truncated draw has the asked variance)
_TRUNCATED_STD = 0.87962566103423978


def flax_default_init(params: Any, seed: int = 0) -> Any:
    """Kernels of a flax params tree drawn from ``lecun_normal`` with a
    ``torch.Generator`` seeded by ``seed``, biases 0, norm scales 1."""
    gen = torch.Generator().manual_seed(int(seed))
    lo, hi = (float(torch.erf(torch.tensor(b / np.sqrt(2.0), dtype=torch.float64)))
              for b in (-2.0, 2.0))

    def visit(tree):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = visit(value)
                continue
            arr = np.asarray(value)
            if key == "kernel":
                std = np.float32(np.sqrt(1.0 / max(_fan_in(arr.shape), 1)) / _TRUNCATED_STD)
                u = torch.rand(arr.shape, generator=gen, dtype=torch.float64) * (hi - lo) + lo
                z = (np.sqrt(2.0) * torch.erfinv(u)).float()
                w = torch.clamp(z * float(std), -2.0 * float(std), 2.0 * float(std))
                out[key] = w.numpy().astype(arr.dtype)
            else:
                out[key] = (np.ones_like if key == "scale" else np.zeros_like)(arr)
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


def init_model(model: nn.Module, seed: int, remat: bool, torch_style: bool = True) -> None:
    """Fill ``model`` with ``torch_style_init`` weights for ``seed`` (or
    :func:`flax_default_init`'s, when not ``torch_style``) and BatchNorm's
    initial statistics (mean 0, variance 1)."""
    def stat_tree(tree: dict) -> dict:
        return {k: stat_tree(v) if isinstance(v, dict) else
                (np.zeros if k == "mean" else np.ones)(v, np.float32) for k, v in tree.items()}

    stats = stat_tree(jax_variable_shapes(model)["batch_stats"])
    draw = torch_style_init if torch_style else flax_default_init
    load_jax_variables(model, draw(flax_param_tree(model, remat), seed), stats)
