"""Task: the model, its losses, the optimizer, and the train and valid steps.

Counterpart of ``some_tpu/training/base_task.py``. The
JAX ``TrainState`` (params, batch_stats, opt_state, step) becomes
:class:`TrainState`: the model (weights, and BatchNorm statistics in its
buffers), the torch optimizer, ``step`` (micro-batches, as the JAX step
counts them) and the gradient accumulator.

One train step, as the JAX step computes it:
  * dropout masks keyed to (seed, step) (``fold_in(base_rng, step)``);
  * the losses, their sum, and the gradients of every parameter;
  * ``grad_norm``, the global norm of those gradients before clipping;
  * with ``accumulate_grad_batches: k``, ``optax.MultiSteps``: the running
    mean of k micro-batches' gradients, one update every k steps;
  * the update: clip by global norm (optax's formula), the lr of the
    schedule at the number of updates applied so far, then AdamW;
  * frozen parameters (``freezing_enabled``, ``frozen_params``) are left out
    of the optimizer, so they get no update, as ``optax.set_to_zero`` gives
    them, and the clip's norm covers the trainable ones, as under
    ``optax.multi_transform``.
The logs stay on the device (0-d tensors), so a step never waits for the
card; the trainer reads them at its log interval.

Several processes (``parallel/distributed.py``): each holds its rows of the
global batch, and the step is the JAX step over that batch. The losses
divide by the global row, frame and label counts (each process's loss is
its share of the global loss), BatchNorm takes its statistics over every
process's frames, each dropout mask is the global batch's mask cut to this
process's rows, the gradients are summed over the processes before the
norm, the clip and the update, and the logs are the global losses; every
process then holds the same parameters.
"""
from __future__ import annotations

import pathlib
from typing import Dict, Optional

import numpy as np
import torch

from some_tpu_torch.data.indexed_dataset import IndexedDataset, load_lengths
from some_tpu_torch.inference.base_infer import resolve_device
from some_tpu_torch.nn.conformer import set_dropout_step, set_sync_batch_stats
from some_tpu_torch.nn.init import init_model
from some_tpu_torch.parallel import distributed as dist
from some_tpu_torch.training.optimizers import (
    build_optimizer, clip_by_global_norm_, global_norm,
)
from some_tpu_torch.training.schedules import build_schedule


class TrainState:
    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 step: int = 0, accumulator: Optional[dict] = None):
        self.model = model
        self.optimizer = optimizer
        self.step = step                 # micro-batches trained
        self.accumulator = accumulator   # {"mini_step", "grads": {name: mean}} mid-group


class BaseTask:
    def __init__(self, config: dict, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.timestep = config["hop_size"] / config["audio_sample_rate"]
        precision = str(config.get("pl_trainer_precision", "32-true"))
        self.compute_dtype = torch.bfloat16 if "bf16" in precision else torch.float32
        self.schedule = build_schedule(config["lr_scheduler_args"],
                                       config["optimizer_args"]["lr"])
        self.clip_grad_norm = config.get("clip_grad_norm")
        self.grad_accum = int(config.get("accumulate_grad_batches", 1) or 1)
        self.frozen_prefixes = ()
        if config.get("freezing_enabled") and config.get("frozen_params"):
            # reference configs name 'model.'-prefixed Lightning keys: match both
            self.frozen_prefixes = tuple(
                q for p in config["frozen_params"]
                for q in ((p, p[len("model."):]) if p.startswith("model.") else (p,)))

    # ---- provided by subclasses ----
    def build_model(self) -> torch.nn.Module:
        raise NotImplementedError

    def compute_losses(self, outputs, batch) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def model_inputs(self, batch) -> dict:
        return dict(x=batch["units"], mask=batch.get("mask"))

    def valid_outputs(self, outputs, batch) -> dict:
        return {}

    def collate(self, items: list) -> dict:
        raise NotImplementedError

    # ---- state ----
    def is_frozen(self, name: str) -> bool:
        return any(name.startswith(p) for p in self.frozen_prefixes)

    def make_optimizer(self, model: torch.nn.Module) -> torch.optim.Optimizer:
        return build_optimizer(self.config["optimizer_args"],
                               [p for n, p in model.named_parameters() if not self.is_frozen(n)])

    def init_state(self, seed: int | None = None) -> TrainState:
        """The model with ``torch_style_init`` weights for ``seed`` (the
        config's by default) drawn in flax's parameter order, so they equal
        the JAX task's ``init_state``, and a fresh optimizer. With
        ``torch_style_init: false``, flax's own initializers' distributions
        (``nn/init.flax_default_init``; other values than JAX's draws)."""
        seed = self.config["seed"] if seed is None else seed
        model = self.build_model()
        init_model(model, seed, remat=bool(self.config.get("use_remat", True)),
                   torch_style=bool(self.config.get("torch_style_init", True)))
        set_sync_batch_stats(model, dist.is_active())
        model.to(self.device).train()
        return TrainState(model, self.make_optimizer(model))

    def to_device(self, batch: dict) -> dict:
        """numpy arrays -> tensors on the task's device; other values pass."""
        out = {}
        for key, value in batch.items():
            if isinstance(value, np.ndarray):
                t = torch.from_numpy(np.ascontiguousarray(value))
                if self.device.type == "cuda":
                    t = t.pin_memory().to(self.device, non_blocking=True)
                out[key] = t
            else:
                out[key] = value
        return out

    # ---- steps ----
    def train_step(self, state: TrainState, batch: dict) -> Dict[str, torch.Tensor]:
        """One micro-batch: forward, backward, and the update when due.
        ``batch`` is a collated numpy batch or one already on the device."""
        model = state.model
        model.train()
        rows = None
        if dist.is_active():  # this process's rows of the global batch
            b = batch["units"].shape[0]
            rows = (dist.rank() * b, dist.world_size() * b)
        set_dropout_step(model, self.config["seed"], state.step, rows)
        if any(isinstance(v, np.ndarray) for v in batch.values()):
            batch = self.to_device(batch)
        outputs = model(**self.model_inputs(batch))
        losses = self.compute_losses(outputs, batch)
        total = sum(losses.values())
        for p in model.parameters():
            p.grad = None
        total.backward()
        named = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
        dist.all_sum_grads_([p.grad for _, p in named])
        grad_norm = global_norm([p.grad for _, p in named])
        k = self.grad_accum
        if k == 1:
            self._apply(state, named)
        else:
            acc = state.accumulator or {"mini_step": 0, "grads": {}}
            n = acc["mini_step"]
            for name, p in named:  # optax.MultiSteps' running mean
                acc["grads"][name] = (p.grad if n == 0 else
                                      (p.grad + n * acc["grads"][name]) / (n + 1))
                p.grad = None
            acc["mini_step"] = n + 1
            state.accumulator = acc
            if n + 1 == k:
                for name, p in named:
                    p.grad = acc["grads"][name]
                self._apply(state, named)
                state.accumulator = None
        state.step += 1
        return self._global_losses(losses, total, grad_norm=grad_norm)

    @staticmethod
    def _global_losses(losses: Dict[str, torch.Tensor], total: torch.Tensor, **extra):
        """The global batch's losses and their ``total_loss``: each
        process's shares summed; one process's own, detached, without a
        group."""
        if not dist.is_active():
            return {**{k: v.detach() for k, v in losses.items()},
                    "total_loss": total.detach(), **extra}
        summed = dist.all_sum(torch.stack([v.detach().float() for v in losses.values()]))
        out = dict(zip(losses, summed.unbind()))
        return {**out, "total_loss": sum(out.values()), **extra}

    def _apply(self, state: TrainState, named) -> None:
        grads = [p.grad for n, p in named if not self.is_frozen(n)]
        if self.clip_grad_norm is not None and self.clip_grad_norm > 0:
            clip_by_global_norm_(grads, float(self.clip_grad_norm))
        lr = self.schedule(state.step // self.grad_accum)  # updates applied so far
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        for _, p in named:
            p.grad = None

    @torch.no_grad()
    def valid_step(self, state: TrainState, batch: dict):
        """Eval-mode forward (running statistics, no dropout, the inference
        kernels): (losses with ``total_loss``, ``valid_outputs``); with
        several processes the global losses and ``midi_acc`` counts."""
        model = state.model
        model.eval()
        try:
            if any(isinstance(v, np.ndarray) for v in batch.values()):
                batch = self.to_device(batch)
            outputs = model(**self.model_inputs(batch))
            losses = self.compute_losses(outputs, batch)
            losses = self._global_losses(losses, sum(losses.values()))
            extras = self.valid_outputs(outputs, batch)
            for key in ("midi_acc_correct", "midi_acc_total"):
                if key in extras:
                    extras[key] = dist.all_sum(extras[key])
            return losses, extras
        finally:
            model.train()

    # ---- datasets ----
    def load_datasets(self):
        data_dir = pathlib.Path(self.config["binary_data_dir"])
        train_prefix = self.config.get("train_set_name", "train")
        valid_prefix = self.config.get("valid_set_name", "valid")
        return ((IndexedDataset(data_dir, train_prefix), load_lengths(data_dir, train_prefix)),
                (IndexedDataset(data_dir, valid_prefix), load_lengths(data_dir, valid_prefix)))
