"""Optimizers with the JAX package's (optax's) update rule.

Counterpart of ``some_tpu/training/optimizers.py``. ``torch.optim.AdamW``
already computes what ``optax.adamw`` does: bias-corrected moments, eps
outside the square root, and the weight decay decoupled from the moments
(``p * (1 - lr * wd)`` against optax's ``- lr * wd * p``). ``optax.adam``
is ``torch.optim.Adam`` with no decay. The learning rate is a 0-d tensor on
the parameters' device that every param group holds; the task fills it
from the schedule before each update (see base_task.py), so a captured
step reads the current rate, as the JAX schedule reads ``count`` inside
the jitted step. On a CUDA device the optimizer is ``capturable`` (its
step count on the device, no host reads), in the eager step as in the
captured one, so the two compute the same arithmetic; torch refuses
``capturable`` on the CPU, which runs the single-tensor update.

Clipping follows ``optax.clip_by_global_norm``: a gradient is left alone
when the global norm is below the limit and otherwise becomes
``g / norm * limit``. ``torch.nn.utils.clip_grad_norm_`` divides by
``norm + 1e-6`` and clips at equality, which would not match.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import torch

_OPTIMIZERS = {"AdamW": torch.optim.AdamW, "Adam": torch.optim.Adam}


def build_optimizer(optimizer_args: dict, params: Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Optimizer:
    """The config's ``optimizer_args`` (``torch.optim.AdamW`` or
    ``torch.optim.Adam``, ``beta1`` / ``beta2`` / ``eps`` / ``weight_decay``)
    -> a torch optimizer over ``params``, its lr a 0-d tensor on their
    device (:func:`bind_lr`). The lr's value is a placeholder: the task
    fills it from the schedule before each update."""
    name = optimizer_args["optimizer_cls"].rpartition(".")[2]
    if name not in _OPTIMIZERS:
        raise NotImplementedError(f"optimizer {optimizer_args['optimizer_cls']!r} is still "
                                  f"to port (have {sorted(_OPTIMIZERS)}): see ROADMAP.md")
    params = list(params)
    device = params[0].device if params else torch.device("cpu")
    kwargs = dict(lr=torch.tensor(float(optimizer_args["lr"]), device=device),
                  betas=(float(optimizer_args.get("beta1", 0.9)),
                         float(optimizer_args.get("beta2", 0.999))),
                  eps=float(optimizer_args.get("eps", 1e-8)), **_device_settings(device))
    if name == "AdamW":
        # optax.adamw's default decay, as the JAX package's AdamW factory
        kwargs["weight_decay"] = float(optimizer_args.get("weight_decay", 1e-2))
    return _OPTIMIZERS[name](params, **kwargs)


def _device_settings(device: torch.device) -> dict:
    """capturable and foreach on a CUDA device; the CPU's single-tensor
    update otherwise (torch takes a tensor lr there only without foreach)."""
    cuda = device.type == "cuda"
    return {"capturable": cuda, "foreach": cuda}


def bind_lr(optimizer: torch.optim.Optimizer, lr: torch.Tensor) -> bool:
    """Make every param group hold ``lr`` (the task's learning-rate tensor)
    and the settings of its device, and a capturable optimizer's step counts
    lie on the device: ``load_state_dict`` puts back the saved groups'
    values (a float lr, another device's settings) and leaves a step count
    saved without ``capturable`` on the host. Returns True if anything
    changed."""
    settings = _device_settings(lr.device)
    changed = False
    for group in optimizer.param_groups:
        if group["lr"] is not lr or any(group.get(k) != v for k, v in settings.items()):
            group.update(lr=lr, **settings)
            changed = True
    if settings["capturable"]:
        for param, state in optimizer.state.items():
            step = state.get("step")
            if isinstance(step, torch.Tensor) and step.device != param.device:
                state["step"] = step.to(param.device, torch.float32)
                changed = True
    return changed


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares over every element), in f32, on the device."""
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scale ``grads`` in place as optax.clip_by_global_norm does; returns
    their global norm (``norm``, when the caller has it already). Runs on
    the device without a host sync."""
    if norm is None:
        norm = global_norm(grads)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))
    return norm
