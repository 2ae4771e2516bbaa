"""Training loop.

Counterpart of ``some_tpu/training/trainer.py``:

  * a deterministic epoch-seeded bucketed sampler, and collation to bucketed
    shapes, read and staged on the device by a prefetch thread
    (``ds_workers``: its lookahead depth; 0 reads in the loop);
  * the task's train step (on the card a CUDA graph per batch bucket from
    its second visit, see ``base_task.py``), whose logs stay on the device
    until a log interval reads them (``lr``, ``steps_per_sec``, the losses):
    they are the step's own tensors, a replay's cloned out of its graph
    before any later replay writes it;
  * validation and a checkpoint every ``val_check_interval`` updates, a final
    checkpoint, and one on SIGTERM or KeyboardInterrupt at the exact sampler
    position, so a resumed run replays the uninterrupted data order;
    validation plots of the first ``num_valid_plots`` batches to the log
    writer (off, with one log line, where matplotlib does not import);
  * auto-resume from the newest checkpoint of the work directory, a port
    checkpoint or a native JAX one; without one, ``finetune_enabled`` starts
    from another run's weights (a port, JAX or reference Lightning file);
  * with ``profile_dir``, one extra traced step at ``step == log_interval``
    (``utils/profiling.trace``, the program's spans of the step in the same
    trace file), counted so an interrupt inside it resumes
    without losing or repeating a batch; on the card it replays the batch's
    graph, whose hand-written kernels are counted from the graph's nodes
    (``graph_kernel_nodes.json`` beside the trace: torch.profiler loses
    records of replays);
  * a resume or a finetune builds a new state, so every graph is captured
    again from it; with several processes a fit releases its graphs when
    it ends, before the caller destroys the process group;
  * several processes (``parallel/distributed.py``): each takes its rank's
    batches of the sampler, pads them to the shapes every rank's batch of
    the step needs (computed from the sampler without communication),
    validates its rows of each validation batch, and only process 0 writes
    checkpoints and logs;
  * spans of the program's recorder (``utils/profiling``) where the time
    goes: ``trainer: wait for batch`` (the loop's wait for the prefetch
    thread, or the inline read at ``ds_workers`` 0), ``prefetch: read``,
    ``prefetch: collate``, ``prefetch: to_device``, ``trainer: log`` (the
    card's logs read at a log interval), ``trainer: validate``,
    ``trainer: checkpoint``; the task's ``task: train_step`` and its parts.
    With ``trace_out`` (``train.py --trace-out PATH``) the whole fit's spans
    are written to PATH as a Chrome trace.
"""
from __future__ import annotations

import logging
import pathlib
import queue
import signal
import threading
import time
from typing import Optional

import numpy as np
import torch

from some_tpu_torch.data.sampler import BucketBatchSampler, EvalBatchSampler
from some_tpu_torch.parallel import distributed as dist
from some_tpu_torch.training.base_task import BaseTask, TrainState
from some_tpu_torch.training.checkpoint import (
    CheckpointManager, latest_checkpoint, list_checkpoints,
)
from some_tpu_torch.utils import profiling
from some_tpu_torch.utils.checkpoint import load_checkpoint

log = logging.getLogger("some_tpu_torch.trainer")


class Trainer:
    def __init__(self, task: BaseTask, work_dir: pathlib.Path | str, log_writer=None):
        self.task = task
        self.config = task.config
        self.work_dir = pathlib.Path(work_dir)
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self.ckpt_manager = CheckpointManager(
            self.work_dir, keep_top_k=self.config.get("num_ckpt_keep", 5),
            permanent_start=self.config.get("permanent_ckpt_start", 0),
            permanent_interval=self.config.get("permanent_ckpt_interval", 0))
        self.log_writer = log_writer
        self.max_updates = self.config.get("max_updates", 100000)
        self.log_interval = self.config.get("log_interval", 100)
        self.val_check_interval = self.config.get("val_check_interval", 1000)
        self.num_sanity_val_steps = self.config.get("num_sanity_val_steps", 1)
        self._resume_epoch = 0
        self._resume_epoch_batch = 0
        #: the last validation's means (losses, midi_acc)
        self.last_validation: dict = {}
        self._plots_ok = None

    # ---- state ----
    def restore_or_init(self) -> TrainState:
        """Resume from the newest checkpoint of the work directory; without
        one, start at step 0 from ``finetune_ckpt_path``'s weights when
        ``finetune_enabled``, else from the task's initial weights."""
        state = self.task.init_state()
        path = latest_checkpoint(self.work_dir)
        if path is None and self.config.get("finetune_enabled"):
            self._load_finetune(state)
            log.info("initialized from finetune checkpoint %s", self.config["finetune_ckpt_path"])
        elif path is not None:
            self._restore(state, load_checkpoint(path))
            log.info("resumed from %s at micro-step %d", path, state.step)
        return state

    def _load_finetune(self, state: TrainState) -> None:
        """Load the weights and BatchNorm statistics of ``finetune_ckpt_path``
        (a port checkpoint, a native JAX one or a reference Lightning file)
        into the fresh model, as the JAX trainer's ``_load_finetune`` does:
        a leaf whose flax name (``params.backbone.out_proj.kernel``,
        ``batch_stats....mean``; matched with and without its collection)
        starts with a prefix of ``finetune_ignored_params`` ('model.'-prefixed
        as reference configs write them, or bare) keeps its fresh value, as
        does a leaf the file lacks; a leaf of another shape raises
        ``ValueError`` under ``finetune_strict_shapes`` (the default), else
        keeps its fresh value with a warning. The optimizer stays fresh."""
        from some_tpu_torch.compat.from_jax import jax_leaf, jax_params_to_state_dict

        ckpt = load_checkpoint(self.config["finetune_ckpt_path"])
        donor = (jax_params_to_state_dict(ckpt["params"], ckpt["batch_stats"])
                 if ckpt["format"] == "jax" else ckpt["state_dict"])
        blacklist = tuple(q for p in (self.config.get("finetune_ignored_params") or [])
                          for q in ((p, p[len("model."):]) if p.startswith("model.") else (p,)))
        strict = self.config.get("finetune_strict_shapes", True)
        merged = {}
        for key, current in state.model.state_dict().items():
            collection, path, _ = jax_leaf(key, current)
            name = ".".join((collection,) + path)
            new = donor.get(key)
            use_new = new is not None and not any(
                name.startswith(b) or name.split(".", 1)[-1].startswith(b) for b in blacklist)
            if use_new and new.shape != current.shape:
                if strict:
                    raise ValueError(f"shape mismatch for {name}: {tuple(new.shape)} vs "
                                     f"{tuple(current.shape)}")
                log.warning("| unmatched key (shape): %s %s vs %s", name, tuple(new.shape),
                            tuple(current.shape))
                use_new = False
            merged[key] = new if use_new else current
        state.model.load_state_dict(merged, strict=True)

    def _restore(self, state: TrainState, ckpt: dict) -> None:
        model, optimizer = state.model, state.optimizer
        if ckpt["format"] == "jax":
            from some_tpu_torch.compat.from_jax import load_jax_variables, optax_state_to_torch

            load_jax_variables(model, ckpt["params"], ckpt["batch_stats"])
            accumulator = None
            if ckpt.get("opt_state") is not None:
                opt_sd, accumulator = optax_state_to_torch(ckpt["opt_state"], model, optimizer)
                optimizer.load_state_dict(opt_sd)
        else:
            model.load_state_dict(ckpt["state_dict"], strict=True)
            if ckpt.get("optimizer") is not None:
                optimizer.load_state_dict(ckpt["optimizer"])
            accumulator = ckpt.get("accumulator")
        if accumulator is not None:
            accumulator = {"mini_step": int(accumulator["mini_step"]),
                           "grads": {k: v.to(self.task.device, torch.float32)
                                     for k, v in accumulator["grads"].items()}}
        meta = ckpt.get("meta") or {}
        k = self.task.grad_accum
        state.step = int(meta.get("micro_step", int(meta.get("step", 0)) * k))
        state.accumulator = accumulator
        self._resume_epoch = int(meta.get("epoch", 0))
        self._resume_epoch_batch = int(meta.get("epoch_batch", 0))

    # ---- logging ----
    def _log_scalars(self, tag_prefix: str, scalars: dict, step: int):
        if self.log_writer is None:
            return
        for key, value in scalars.items():
            self.log_writer.add_scalar(f"{tag_prefix}/{key}", float(value), step)

    # ---- data ----
    def _epoch_batches(self, sampler, epoch: int, train_ds, sizes):
        """(index list, common shapes or None) of this process's batches.

        With several processes the sampler, a pure function of (seed,
        epoch), gives every rank's batches, so each process finds the step's
        maxima over all ranks (frames, rows, notes) without communicating;
        note counts come from the dataset's shapes, not its data."""
        sampler.set_epoch(epoch)
        if dist.world_size() == 1:
            for batch in sampler:
                yield batch, None
            return
        all_ranks = sampler.form_all_batches()
        note_len = (getattr(train_ds, "attr_length", None)  # in-memory items: read them
                    or (lambda i, key: len(train_ds[i][key])))
        for t, batch in enumerate(all_ranks[dist.rank()]):
            step_batches = [r[t] for r in all_ranks]
            yield batch, {"t": max(max(int(sizes[i]) for i in b) for b in step_batches),
                          "b": max(len(b) for b in step_batches),
                          "n": max(max(note_len(i, "note_midi") for i in b)
                                   for b in step_batches)}

    def _prepared_batches(self, epoch_iter, train_ds):
        """(index list, common) -> (index list, batch on the device), read,
        collated and staged ahead by a worker thread while the card runs
        earlier steps."""
        def prepare(args):
            idx_list, common = args
            with profiling.span("prefetch: read"):
                items = [train_ds[i] for i in idx_list]
            with profiling.span("prefetch: collate"):
                batch = (self.task.collate(items) if common is None
                         else self.task.collate(items, common=common))
            with profiling.span("prefetch: to_device"):
                return idx_list, self.task.to_device(batch)

        depth = int(self.config.get("ds_workers", 1) or 0)
        if depth <= 0:
            for args in epoch_iter:
                with profiling.span("trainer: wait for batch"):
                    prepared = prepare(args)
                yield prepared
            return

        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()
        sentinel = object()

        def worker():
            try:
                for args in epoch_iter:
                    if stop.is_set():
                        return
                    q.put(prepare(args))
                q.put(sentinel)
            except BaseException as exc:  # raised again on the main thread
                q.put(exc)

        thread = threading.Thread(target=worker, daemon=True, name="some_tpu_torch-prefetch")
        thread.start()
        try:
            while True:
                with profiling.span("trainer: wait for batch"):
                    item = q.get()
                if item is sentinel:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while not q.empty():  # unblock a worker parked on put()
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    # ---- main loop ----
    def fit(self, max_steps: Optional[int] = None) -> TrainState:
        """Train to ``max_updates`` (or ``max_steps``). With ``trace_out``
        (a path) the span recorder is on for the whole fit and written
        there as a Chrome trace when it ends (``.rank<N>`` before the suffix
        in a process group of several)."""
        trace_out = self.config.get("trace_out")
        if not trace_out:
            return self._fit(max_steps)
        if dist.world_size() > 1:
            trace_out = pathlib.Path(trace_out)
            trace_out = trace_out.with_name(f"{trace_out.stem}.rank{dist.rank()}"
                                            f"{trace_out.suffix}")
        profiling.enable()
        try:
            return self._fit(max_steps)
        finally:
            profiling.disable()
            log.info("spans written to %s", profiling.dump(trace_out))

    def _fit(self, max_steps: Optional[int]) -> TrainState:
        config = self.config
        (train_ds, train_sizes), (valid_ds, valid_sizes) = self.task.load_datasets()
        sampler = BucketBatchSampler(
            sizes=train_sizes, max_batch_frames=config["max_batch_frames"],
            max_batch_size=config["max_batch_size"],
            frame_count_grid=config.get("sampler_frame_count_grid", 6),
            required_batch_count_multiple=config.get("accumulate_grad_batches", 1),
            sort_by_similar_size=config.get("sort_by_len", True),
            shuffle=True, seed=config["seed"], num_replicas=dist.world_size(),
            rank=dist.rank())
        # every process builds the same validation batches and runs its rows
        # of each, so the collective steps stay in step
        val_sampler = EvalBatchSampler(
            sizes=valid_sizes, max_batch_frames=config.get("max_val_batch_frames", 10000),
            max_batch_size=config.get("max_val_batch_size", 1))

        state = self.restore_or_init()
        k = self.task.grad_accum
        target = min(self.max_updates, max_steps or self.max_updates) * k
        if self.num_sanity_val_steps and state.step == 0:
            self._validate(state, valid_ds, val_sampler, limit=self.num_sanity_val_steps,
                           sanity=True)

        profile_dir = config.get("profile_dir")
        # the sampler is a pure function of (seed, epoch): skipping the first
        # `skip` batches replays the uninterrupted data order
        skip = self._resume_epoch_batch
        epoch_batch = skip
        micro_step = state.step
        # (epoch, micro-step at epoch start, skip at epoch start, extra traced
        # steps this epoch), replaced in one store so an interrupt never sees
        # it half updated
        anchor = (self._resume_epoch, micro_step, skip, 0)
        t_last = time.time()

        def _sigterm(signum, frame):
            raise KeyboardInterrupt("SIGTERM")

        installed, prev_handler = False, None
        try:
            prev_handler = signal.signal(signal.SIGTERM, _sigterm)
            installed = True
        except ValueError:  # not the main thread
            pass
        try:
            while micro_step < target:
                epoch = anchor[0]
                epoch_batch = 0
                epoch_iter = self._epoch_batches(sampler, epoch, train_ds, train_sizes)
                # consume the resume skip before the prefetcher: no reads
                while skip > 0:
                    if next(epoch_iter, None) is None:
                        break
                    skip -= 1
                    epoch_batch += 1
                hit_target = False

                def stop_at_target(it):
                    nonlocal hit_target
                    for args in it:
                        if micro_step >= target:
                            hit_target = True
                            return
                        yield args

                for idx_list, batch in self._prepared_batches(stop_at_target(epoch_iter),
                                                              train_ds):
                    if micro_step >= target:
                        break
                    logs = self.task.train_step(state, batch)
                    micro_step += 1
                    epoch_batch += 1
                    step = micro_step // k
                    if profile_dir and step == self.log_interval:
                        # one traced step on the same batch, after the warm-up;
                        # counted before it runs, so an interrupt inside it at
                        # worst trains the batch again after resuming, never
                        # skips one
                        anchor = anchor[:3] + (anchor[3] + 1,)
                        from some_tpu_torch.utils.profiling import trace

                        with trace(profile_dir):
                            logs = self.task.train_step(state, batch)
                        self._graph_launches(profile_dir, step)
                        micro_step += 1
                        step = micro_step // k
                    if micro_step % (self.log_interval * k) == 0:
                        with profiling.span("trainer: log"):  # reads the card's logs
                            scalars = {key: float(v) for key, v in logs.items()}
                            scalars["lr"] = self.task.schedule(step - 1)
                            scalars["batch_size"] = len(idx_list)
                            now = time.time()
                            scalars["steps_per_sec"] = (self.log_interval / (now - t_last)
                                                        if step > self.log_interval else 0.0)
                            t_last = now
                            self._log_scalars("training", scalars, step)
                            log.info("step %d | %s", step,
                                     " ".join(f"{key}={v:.5g}" for key, v in scalars.items()))
                    if micro_step % (self.val_check_interval * k) == 0:
                        self._validate(state, valid_ds, val_sampler)
                        self._save_ckpt(step, state, epoch, epoch_batch)
                else:
                    if not hit_target:  # the epoch ran out: next epoch
                        epoch_batch = 0
                        anchor = (epoch + 1, micro_step, skip, 0)
                    continue
                break
        except KeyboardInterrupt:
            # the batches consumed this epoch: those skipped on entry plus the
            # micro-steps applied since, counted from the state, less the
            # traced repeats
            a_epoch, a_micro, a_skip, a_extra = anchor
            epoch_batch = (a_skip - skip) + (state.step - a_micro) - a_extra
            log.warning("interrupted at micro-step %d; saving a checkpoint", state.step)
            self._save_ckpt(state.step // k, state, a_epoch, epoch_batch)
            raise
        finally:
            if installed:  # a disposition set outside Python reads as None
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None else signal.SIG_DFL)
            if dist.is_active():  # before the caller destroys the group
                self.task.release_graphs(state)

        final_step = state.step // k
        ckpts = list_checkpoints(self.work_dir)
        if not ckpts or final_step > ckpts[-1][0]:
            self._save_ckpt(final_step, state, anchor[0], epoch_batch)
        return state

    def _graph_launches(self, profile_dir: str, step: int) -> None:
        """The hand-written kernels of the graph the traced step replayed,
        counted from its nodes, logged and written beside the trace."""
        entry = self.task.last_graph
        if entry is None:
            return
        import json

        from some_tpu_torch.utils.profiling import hand_written_nodes

        counts = hand_written_nodes(entry.graph, training=True)
        log.info("profiled step %d (%s): hand-written kernel nodes %s", step,
                 self.task.last_dispatch, counts)
        (pathlib.Path(profile_dir) / "graph_kernel_nodes.json").write_text(json.dumps(
            {"step": step, "dispatch": self.task.last_dispatch, "kernels": counts}))

    def _save_ckpt(self, step: int, state: TrainState, epoch: int, epoch_batch: int) -> None:
        """Process 0 writes (every process holds the same state)."""
        if dist.rank() != 0:
            return
        with profiling.span("trainer: checkpoint"):
            self.ckpt_manager.save(
                step, state.model.state_dict(), state.optimizer.state_dict(), state.accumulator,
                extra_meta={"micro_step": state.step, "epoch": epoch,
                            "epoch_batch": epoch_batch})

    # ---- validation ----
    def _plots_available(self) -> bool:
        """matplotlib imports (asked once; the card's machine has none)."""
        if self._plots_ok is None:
            try:
                import matplotlib  # noqa: F401
                self._plots_ok = True
            except ImportError:
                log.info("validation plots are off: matplotlib does not import")
                self._plots_ok = False
        return self._plots_ok

    def _validate(self, state: TrainState, valid_ds, val_sampler,
                  limit: Optional[int] = None, sanity: bool = False) -> dict:
        """Every process runs every batch, its rows of it (the batch padded to
        a multiple of the process count); the losses and counts come back
        global. The first ``num_valid_plots`` batches of a validation that is
        not the sanity check are plotted where a log writer exists."""
        with profiling.span("trainer: validate"):
            return self._validate_batches(state, valid_ds, val_sampler, limit, sanity)

    def _validate_batches(self, state: TrainState, valid_ds, val_sampler,
                          limit: Optional[int], sanity: bool) -> dict:
        n_proc, rank = dist.world_size(), dist.rank()
        plots = (0 if sanity or self.log_writer is None
                 else int(self.config.get("num_valid_plots", 0) or 0))
        if plots and not hasattr(self.task, "validation_plots"):
            plots = 0
        if plots and not self._plots_available():
            plots = 0
        loss_sums: dict = {}
        weight_sum = acc_correct = acc_total = 0
        for batch_idx, idx_list in enumerate(val_sampler):
            if limit is not None and batch_idx >= limit:
                break
            items = [valid_ds[i] for i in idx_list]
            if n_proc == 1:
                batch = local = self.task.collate(items)
            else:
                batch = self.task.collate(items, common={"b": n_proc, "b_multiple": n_proc})
                b_loc = batch["batch_mask"].shape[0] // n_proc
                lo = rank * b_loc
                local = {key: (v[lo:lo + b_loc] if key != "t_real" and np.ndim(v) > 0 else v)
                         for key, v in batch.items()}
            losses, extras = self.task.valid_step(state, local)
            for key, value in losses.items():
                loss_sums[key] = loss_sums.get(key, 0.0) + float(value) * len(idx_list)
            weight_sum += len(idx_list)
            if "midi_acc_correct" in extras:
                acc_correct += int(extras["midi_acc_correct"])
                acc_total += int(extras["midi_acc_total"])
            if batch_idx < plots:
                try:
                    self.task.validation_plots(self, batch_idx, batch, extras, state.step)
                except Exception:  # a figure never stops training
                    log.warning("validation plot of batch %d failed", batch_idx, exc_info=True)
        means = {key: v / weight_sum for key, v in loss_sums.items()} if weight_sum else {}
        if means:
            self._log_scalars("validation", means, state.step)
            if acc_total:
                means["midi_acc"] = acc_correct / acc_total
                self._log_scalars("metrics", {"midi_acc": means["midi_acc"]}, state.step)
            if rank == 0:
                log.info("validation @ %d | %s", state.step,
                         " ".join(f"{key}={v:.5g}" for key, v in means.items()))
        self.last_validation = means
        return means
