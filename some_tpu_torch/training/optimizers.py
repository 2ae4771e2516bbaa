"""Optimizers with the JAX package's (optax's) update rule.

Counterpart of ``some_tpu/training/optimizers.py``. ``torch.optim.AdamW``
already computes what ``optax.adamw`` does: bias-corrected moments, eps
outside the square root, and the weight decay decoupled from the moments
(``p * (1 - lr * wd)`` against optax's ``- lr * wd * p``). ``optax.adam``
is ``torch.optim.Adam`` with no decay. The learning rate is set on each
param group before each update from the schedule (see base_task.py).

Clipping follows ``optax.clip_by_global_norm``: a gradient is left alone
when the global norm is below the limit and otherwise becomes
``g / norm * limit``. ``torch.nn.utils.clip_grad_norm_`` divides by
``norm + 1e-6`` and clips at equality, which would not match.
"""
from __future__ import annotations

from typing import Iterable, List

import torch

_OPTIMIZERS = {"AdamW": torch.optim.AdamW, "Adam": torch.optim.Adam}


def build_optimizer(optimizer_args: dict, params: Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Optimizer:
    """The config's ``optimizer_args`` (``torch.optim.AdamW`` or
    ``torch.optim.Adam``, ``beta1`` / ``beta2`` / ``eps`` / ``weight_decay``)
    -> a torch optimizer over ``params``. The lr is a placeholder: the task
    sets it from the schedule before each update."""
    name = optimizer_args["optimizer_cls"].rpartition(".")[2]
    if name not in _OPTIMIZERS:
        raise NotImplementedError(f"optimizer {optimizer_args['optimizer_cls']!r} is still "
                                  f"to port (have {sorted(_OPTIMIZERS)}): see ROADMAP.md")
    kwargs = dict(lr=float(optimizer_args["lr"]),
                  betas=(float(optimizer_args.get("beta1", 0.9)),
                         float(optimizer_args.get("beta2", 0.999))),
                  eps=float(optimizer_args.get("eps", 1e-8)))
    if name == "AdamW":
        # optax.adamw's default decay, as the JAX package's AdamW factory
        kwargs["weight_decay"] = float(optimizer_args.get("weight_decay", 1e-2))
    return _OPTIMIZERS[name](list(params), **kwargs)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares over every element), in f32, on the device."""
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place as optax.clip_by_global_norm does; returns
    their global norm. Runs on the device without a host sync."""
    norm = global_norm(grads)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))
    return norm
