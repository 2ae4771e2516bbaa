"""Task: the model, its losses, the optimizer, and the train and valid steps.

Counterpart of ``some_tpu/training/base_task.py``. The
JAX ``TrainState`` (params, batch_stats, opt_state, step) becomes
:class:`TrainState`: the model (weights, and BatchNorm statistics in its
buffers), the torch optimizer, the learning rate (a 0-d tensor), ``step``
(micro-batches, as the JAX step counts them) and the gradient accumulator.

One train step, as the JAX step computes it:
  * dropout masks keyed to (seed, step) (``fold_in(base_rng, step)``);
  * the losses, their sum, and the gradients of every parameter;
  * ``grad_norm``, the global norm of those gradients before clipping;
  * with ``accumulate_grad_batches: k``, ``optax.MultiSteps``: the running
    mean of k micro-batches' gradients, one update every k steps;
  * the update: clip by global norm (optax's formula; with no frozen
    parameter and k = 1 the clip takes ``grad_norm`` itself), the lr of the
    schedule at the number of updates applied so far, then AdamW;
  * frozen parameters (``freezing_enabled``, ``frozen_params``) are left out
    of the optimizer, so they get no update, as ``optax.set_to_zero`` gives
    them, and the clip's norm covers the trainable ones, as under
    ``optax.multi_transform``.
The logs stay on the device (0-d tensors), so a step never waits for the
card; the trainer reads them at its log interval.

A step is a host prologue (the dropout keys, the lr of the schedule, the
batch on the device), a device body (the rest, above) and a host epilogue
(the step count, the accumulator's position). On a CUDA device the body is
compiled as the JAX step is jitted: one CUDA graph per batch bucket shape
(rows, frames, notes: what ``pad_to_bucket`` makes, as XLA compiles one
program per shape) and per accumulation position. A bucket's first visit
runs the body eagerly, which fills every first-call cache and makes the
optimizer's state; its second captures the body, then replays it; later
visits replay. Everything the body updates lives outside the graphs'
memory pool and is updated in place (the counterpart of JAX's donation):
the parameters, the BatchNorm statistics, AdamW's moments and step counts,
the lr tensor, the dropout generators and the gradient accumulator. The
inputs are copied into the graph's own tensors before a replay and the
logs cloned out of its outputs after it, before any other replay can
write them. All train graphs share one pool, the valid graphs another;
every step, eager or replayed, runs on the task's one compute stream, so
replays run one after another and an eager step warms that stream's
caches. The CPU runs every step eagerly. :func:`set_train_dispatch` is the
test-only switch to the eager dispatch on the card.

While the span recorder (``utils/profiling``) records, a train step is a
``task: train_step`` span (rows, frames, real frames where ``to_device``
counted them on the host, how it ran) holding ``task:
prepare`` (train mode, the dropout step, the inputs on the device, the lr
bound and filled), ``task: capture`` where it captures, then ``task: copy
inputs``, ``task: replay`` and ``task: clone outputs``, or ``task: eager``.

Several processes (``parallel/distributed.py``): each holds its rows of the
global batch, and the step is the JAX step over that batch. The losses
divide by the global row, frame and label counts (each process's loss is
its share of the global loss), BatchNorm takes its statistics over every
process's frames, each dropout mask is the global batch's mask cut to this
process's rows, the gradients are summed over the processes before the
norm, the clip and the update, and the logs are the global losses; every
process then holds the same parameters. Those sums run inside a captured
step too (NCCL; the first, eager, visit makes the communicator).
"""
from __future__ import annotations

import contextlib
import pathlib
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from some_tpu_torch.data.indexed_dataset import IndexedDataset, load_lengths
from some_tpu_torch.inference.base_infer import resolve_device
from some_tpu_torch.nn.conformer import (
    dropout_generators, seed_dropout, set_dropout_step, set_sync_batch_stats,
)
from some_tpu_torch.nn.init import init_model
from some_tpu_torch.parallel import distributed as dist
from some_tpu_torch.training.optimizers import (
    bind_lr, build_optimizer, clip_by_global_norm_, global_norm,
)
from some_tpu_torch.training.schedules import build_schedule
from some_tpu_torch.utils import profiling


class TrainState:
    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 step: int = 0, accumulator: Optional[dict] = None):
        self.model = model
        self.optimizer = optimizer
        self.step = step                 # micro-batches trained
        self.accumulator = accumulator   # {"mini_step", "grads": {name: mean}} mid-group
        #: the learning rate every param group holds (a 0-d tensor), bound
        #: at the first step
        self.lr: Optional[torch.Tensor] = None
        #: the accumulator's tensors, made once and updated in place
        self.acc_grads: Optional[Dict[str, torch.Tensor]] = None
        #: captured steps by (kind, input shapes), visits by the same key,
        #: the memory pools ("train", "valid")
        self.graphs: Dict[tuple, "StepGraph"] = {}
        self.visits: Dict[tuple, int] = {}
        self.pools: Dict[str, tuple] = {}

    def static_tensors(self) -> list:
        """Every tensor a step updates in place: the parameters, the buffers,
        the optimizer's state, the lr and the accumulator."""
        out = list(self.model.parameters()) + list(self.model.buffers())
        if self.optimizer is not None:
            out += [v for st in self.optimizer.state.values() for v in st.values()
                    if isinstance(v, torch.Tensor)]
        if self.lr is not None:
            out.append(self.lr)
        out += list((self.acc_grads or {}).values())
        return out


class StepGraph:
    """One captured step: its input tensors, its graph and its outputs (the
    body's return value, written in place by each replay)."""

    def __init__(self, inputs: Dict[str, torch.Tensor], graph, out):
        self.inputs, self.graph, self.out = inputs, graph, out


def set_train_dispatch(task: "BaseTask", mode: str) -> None:
    """Test-only switch: 'graph' (the default on a CUDA device) replays one
    CUDA graph per batch bucket from a bucket's second visit on, 'eager'
    runs every step op by op (to hold the two against each other). The CPU
    always runs eagerly; no config key or CLI flag reads this."""
    if mode not in ("graph", "eager"):
        raise ValueError(f"unknown dispatch {mode!r} (graph | eager)")
    if mode == "graph" and task.device.type != "cuda":
        raise ValueError(f"captured steps run on a CUDA device; {task.device} runs eagerly")
    task._dispatch = mode


class BaseTask:
    #: the visit of a batch bucket that captures its step (see the module's
    #: docstring); the engine's ``CAPTURE_ON_VISIT`` likewise
    CAPTURE_ON_VISIT = 2

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
        self._dispatch = "graph" if self.device.type == "cuda" else "eager"
        #: the compute stream of every step on the card
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        #: how the last step ran: 'eager', 'capture' (captured, then replayed) or 'replay'
        self.last_dispatch: Optional[str] = None
        #: the graph the last captured or replayed step ran
        self.last_graph: Optional[StepGraph] = None

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
        """numpy arrays -> tensors on the task's device; other values pass.
        A numpy ``mask``'s real frames are put in as ``real_frames`` (an int,
        counted on the host so that no count waits for the card)."""
        out = {}
        for key, value in batch.items():
            if isinstance(value, np.ndarray):
                t = torch.from_numpy(np.ascontiguousarray(value))
                if self.device.type == "cuda":
                    t = t.pin_memory().to(self.device, non_blocking=True)
                out[key] = t
            else:
                out[key] = value
        if isinstance(batch.get("mask"), np.ndarray):
            out["real_frames"] = int(np.count_nonzero(batch["mask"]))
        return out

    def _bind(self, state: TrainState) -> None:
        """The state's lr tensor, held by every param group with its device's
        settings; a change (a state_dict loaded into the optimizer) drops the
        state's captured train steps, which read the old tensors."""
        if state.lr is None:
            lr = state.optimizer.param_groups[0]["lr"]
            state.lr = (lr if isinstance(lr, torch.Tensor) and lr.device == self.device
                        else torch.tensor(float(lr), device=self.device))
        if bind_lr(state.optimizer, state.lr):
            for key in [k for k in state.graphs if k[0][0] == "train"]:
                del state.graphs[key]

    def _accumulator(self, state: TrainState) -> int:
        """The accumulation position of this step (``mini_step``), with the
        state's accumulator in its own tensors (made at the first step; a
        restored accumulator is copied into them)."""
        if state.acc_grads is None:
            state.acc_grads = {n: torch.zeros_like(p, dtype=torch.float32)
                               for n, p in state.model.named_parameters() if p.requires_grad}
        acc = state.accumulator
        if acc is None:
            return 0
        if acc["grads"] is not state.acc_grads:
            for name, value in acc["grads"].items():
                state.acc_grads[name].copy_(value)
            state.accumulator = {"mini_step": int(acc["mini_step"]), "grads": state.acc_grads}
        return int(acc["mini_step"])

    @contextlib.contextmanager
    def _on_stream(self, batch: dict):
        """Run the block on the task's compute stream (on the card), after
        what the current stream has queued (the batch's copies); the current
        stream waits for the block's work after it. Yields the current
        stream (None on the CPU)."""
        if self._stream is None:
            yield None
            return
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        for value in batch.values():
            if isinstance(value, torch.Tensor) and value.is_cuda:
                value.record_stream(self._stream)
        with torch.cuda.stream(self._stream):
            yield current
        current.wait_stream(self._stream)

    # ---- the compiled dispatch ----
    def _step_entry(self, state: TrainState, kind: tuple, batch: dict, body):
        """The captured step of ``kind`` for this batch's shapes, capturing
        it at its ``CAPTURE_ON_VISIT``-th visit; None to run eagerly."""
        if self._dispatch != "graph":
            return None
        tensors = {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}
        key = (kind, tuple(sorted((k, tuple(v.shape), v.dtype) for k, v in tensors.items())))
        entry = state.graphs.get(key)
        if entry is None:
            visit = state.visits[key] = state.visits.get(key, 0) + 1
            if visit < self.CAPTURE_ON_VISIT:
                return None
            with profiling.span("task: capture"):
                inputs = {k: v.clone() for k, v in tensors.items()}
                static = dict(batch, **inputs)  # other values: the capture's
                generators = dropout_generators(state.model) if kind[0] == "train" else []
                graph, out = self._capture_graph(state, kind[0], lambda: body(static),
                                                 generators)
            entry = state.graphs[key] = StepGraph(inputs, graph, out)
            self.last_dispatch = "capture"
        else:
            self.last_dispatch = "replay"
        return entry

    def release_graphs(self, state: TrainState) -> None:
        """Drop the state's captured steps (a later visit captures again).
        Before a process group that their collectives ran in is destroyed:
        NCCL's teardown waits for the graphs that captured its collectives,
        and hangs while they live."""
        state.graphs.clear()
        state.visits.clear()
        self.last_graph = None
        if self._stream is not None:
            torch.cuda.synchronize(self.device)

    def _capture_graph(self, state: TrainState, pool: str, run, generators):
        """Capture ``run()`` into a CUDA graph of the state's ``pool``, the
        dropout ``generators`` registered with it (a replay draws from the
        offsets their seeds give); returns (graph, the outputs). The graph
        keeps its node list (``keep_graph``) for ``utils.profiling``'s
        node counts. Nothing runs: the caller replays it."""
        if self.device.type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError(f"a captured step needs a CUDA device; the task's is "
                               f"{self.device} (the CPU runs every step eagerly)")
        if pool not in state.pools:
            state.pools[pool] = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in generators:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, pool=state.pools[pool], stream=self._stream,
                              capture_error_mode="thread_local"):
            out = run()
        return graph, out

    def _run(self, state: TrainState, kind: tuple, batch: dict, body, caller=None):
        """One step's device work: the body eagerly, or the bucket's graph
        (its inputs copied in, the dropout generators seeded, one replay,
        its outputs cloned out). ``caller``: the stream that reads the
        outputs (``_on_stream``'s)."""
        self.last_dispatch, self.last_graph = "eager", None
        entry = self._step_entry(state, kind, batch, body)
        if entry is None:
            with profiling.span("task: eager"):
                out = body(batch)
        else:
            with profiling.span("task: copy inputs"):
                for name, value in entry.inputs.items():
                    value.copy_(batch[name])
            with profiling.span("task: replay"):
                if kind[0] == "train":
                    seed_dropout(state.model)
                entry.graph.replay()
            self.last_graph = entry
            with profiling.span("task: clone outputs"):
                out = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                               entry.out)
        if caller is not None:  # made on the compute stream, read on the caller's
            tree_map(lambda t: t.record_stream(caller) if isinstance(t, torch.Tensor) else t,
                     out)
        return out

    # ---- steps ----
    def train_step(self, state: TrainState, batch: dict) -> Dict[str, torch.Tensor]:
        """One micro-batch: forward, backward, and the update when due.
        ``batch`` is a collated numpy batch or one already on the device.
        The logs are the step's own tensors (a replay's are cloned out)."""
        with profiling.span("task: train_step") as sp, contextlib.ExitStack() as on_stream:
            with profiling.span("task: prepare"):
                model = state.model
                model.train()
                rows = None
                if dist.is_active():  # this process's rows of the global batch
                    b = batch["units"].shape[0]
                    rows = (dist.rank() * b, dist.world_size() * b)
                set_dropout_step(model, self.config["seed"], state.step, rows)
                if any(isinstance(v, np.ndarray) for v in batch.values()):
                    batch = self.to_device(batch)
                k = self.grad_accum
                caller = on_stream.enter_context(self._on_stream(batch))
                self._bind(state)
                mini = None if k == 1 else self._accumulator(state)
                applies = mini is None or mini + 1 == k
                if applies:  # the lr of the updates applied so far
                    state.lr.fill_(self.schedule(state.step // k))
            logs = self._run(state, ("train", mini), batch,
                             lambda b: self._train_body(state, b, mini), caller)
            on_stream.close()  # the current stream waits for the step's work
            if mini is not None:
                state.accumulator = (None if applies else
                                     {"mini_step": mini + 1, "grads": state.acc_grads})
            state.step += 1
            if sp:
                sp.attrs.update(rows=batch["mask"].shape[0], frames=batch["mask"].shape[1],
                                dispatch=self.last_dispatch)
                if "real_frames" in batch:
                    sp.attrs["real_frames"] = batch["real_frames"]
        return logs

    def _train_body(self, state: TrainState, batch: dict, mini: Optional[int]):
        """The device work of a train step at accumulation position ``mini``
        (None without accumulation): what a graph captures."""
        model = state.model
        outputs = model(**self.model_inputs(batch))
        losses = self.compute_losses(outputs, batch)
        total = sum(losses.values())
        for p in model.parameters():
            p.grad = None
        total.backward()
        named = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
        dist.all_sum_grads_([p.grad for _, p in named])
        grad_norm = global_norm([p.grad for _, p in named])
        if mini is None:
            self._apply(state, named, None if self.frozen_prefixes else grad_norm)
        else:
            acc = state.acc_grads
            for name, p in named:  # optax.MultiSteps' running mean
                if mini == 0:
                    acc[name].copy_(p.grad)
                else:
                    acc[name].copy_((p.grad + mini * acc[name]) / (mini + 1))
                p.grad = None
            if mini + 1 == self.grad_accum:
                for name, p in named:
                    p.grad = acc[name]
                self._apply(state, named)
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

    def _apply(self, state: TrainState, named, norm: Optional[torch.Tensor] = None) -> None:
        """Clip (by ``norm`` when it is the trainable gradients' norm
        already), then the optimizer's update at the lr tensor's value."""
        grads = [p.grad for n, p in named if not self.is_frozen(n)]
        if self.clip_grad_norm is not None and self.clip_grad_norm > 0:
            clip_by_global_norm_(grads, float(self.clip_grad_norm), norm)
        state.optimizer.step()
        for _, p in named:
            p.grad = None

    @torch.no_grad()
    def valid_step(self, state: TrainState, batch: dict):
        """Eval-mode forward (running statistics, no dropout, the inference
        kernels): (losses with ``total_loss``, ``valid_outputs``); with
        several processes the global losses and ``midi_acc`` counts. On the
        card one graph per valid bucket, as the train step."""
        model = state.model
        model.eval()
        try:
            if any(isinstance(v, np.ndarray) for v in batch.values()):
                batch = self.to_device(batch)
            with self._on_stream(batch) as caller:
                return self._run(state, ("valid", None), batch,
                                 lambda b: self._valid_body(state, b), caller)
        finally:
            model.train()

    def _valid_body(self, state: TrainState, batch: dict):
        outputs = state.model(**self.model_inputs(batch))
        losses = self.compute_losses(outputs, batch)
        losses = self._global_losses(losses, sum(losses.values()))
        extras = self.valid_outputs(outputs, batch)
        for key in ("midi_acc_correct", "midi_acc_total"):
            if key in extras:
                extras[key] = dist.all_sum(extras[key])
        return losses, extras

    # ---- datasets ----
    def load_datasets(self):
        data_dir = pathlib.Path(self.config["binary_data_dir"])
        train_prefix = self.config.get("train_set_name", "train")
        valid_prefix = self.config.get("valid_set_name", "valid")
        return ((IndexedDataset(data_dir, train_prefix), load_lengths(data_dir, train_prefix)),
                (IndexedDataset(data_dir, valid_prefix), load_lengths(data_dir, valid_prefix)))
