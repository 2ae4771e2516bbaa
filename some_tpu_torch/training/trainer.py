"""Training loop, single process.

Counterpart of ``some_tpu/training/trainer.py``:

  * a deterministic epoch-seeded bucketed sampler, and collation to bucketed
    shapes, read and staged on the device by a prefetch thread
    (``ds_workers``: its lookahead depth; 0 reads in the loop);
  * the task's train step, whose logs stay on the device until a log
    interval reads them (``lr``, ``steps_per_sec``, the losses);
  * validation and a checkpoint every ``val_check_interval`` updates, a final
    checkpoint, and one on SIGTERM or KeyboardInterrupt at the exact sampler
    position, so a resumed run replays the uninterrupted data order;
  * auto-resume from the newest checkpoint of the work directory, a port
    checkpoint or a native JAX one.

Left out (see ROADMAP.md): several processes or devices, the profile
window, finetuning from another run, validation plots.
"""
from __future__ import annotations

import logging
import pathlib
import queue
import signal
import threading
import time
from typing import Optional

import torch

from some_tpu_torch.data.sampler import BucketBatchSampler, EvalBatchSampler
from some_tpu_torch.training.base_task import BaseTask, TrainState
from some_tpu_torch.training.checkpoint import (
    CheckpointManager, latest_checkpoint, list_checkpoints,
)
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

    # ---- state ----
    def restore_or_init(self) -> TrainState:
        if self.config.get("finetune_enabled") and latest_checkpoint(self.work_dir) is None:
            raise NotImplementedError("finetune_enabled is still to port: see ROADMAP.md")
        state = self.task.init_state()
        path = latest_checkpoint(self.work_dir)
        if path is not None:
            self._restore(state, load_checkpoint(path))
            log.info("resumed from %s at micro-step %d", path, state.step)
        return state

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
    def _prepared_batches(self, epoch_iter, train_ds):
        """index lists -> (index list, batch on the device), read, collated and
        staged ahead by a worker thread while the card runs earlier steps."""
        def prepare(idx_list):
            batch = self.task.collate([train_ds[i] for i in idx_list])
            return idx_list, self.task.to_device(batch)

        depth = int(self.config.get("ds_workers", 1) or 0)
        if depth <= 0:
            for idx_list in epoch_iter:
                yield prepare(idx_list)
            return

        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()
        sentinel = object()

        def worker():
            try:
                for idx_list in epoch_iter:
                    if stop.is_set():
                        return
                    q.put(prepare(idx_list))
                q.put(sentinel)
            except BaseException as exc:  # raised again on the main thread
                q.put(exc)

        thread = threading.Thread(target=worker, daemon=True, name="some_tpu_torch-prefetch")
        thread.start()
        try:
            while True:
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
        config = self.config
        (train_ds, train_sizes), (valid_ds, valid_sizes) = self.task.load_datasets()
        sampler = BucketBatchSampler(
            sizes=train_sizes, max_batch_frames=config["max_batch_frames"],
            max_batch_size=config["max_batch_size"],
            frame_count_grid=config.get("sampler_frame_count_grid", 6),
            required_batch_count_multiple=config.get("accumulate_grad_batches", 1),
            sort_by_similar_size=config.get("sort_by_len", True),
            shuffle=True, seed=config["seed"])
        val_sampler = EvalBatchSampler(
            sizes=valid_sizes, max_batch_frames=config.get("max_val_batch_frames", 10000),
            max_batch_size=config.get("max_val_batch_size", 1))

        state = self.restore_or_init()
        k = self.task.grad_accum
        target = min(self.max_updates, max_steps or self.max_updates) * k
        if self.num_sanity_val_steps and state.step == 0:
            self._validate(state, valid_ds, val_sampler, limit=self.num_sanity_val_steps)

        # the sampler is a pure function of (seed, epoch): skipping the first
        # `skip` batches replays the uninterrupted data order
        skip = self._resume_epoch_batch
        epoch_batch = skip
        micro_step = state.step
        # (epoch, micro-step at epoch start, skip at epoch start), replaced in
        # one store so an interrupt never sees it half updated
        anchor = (self._resume_epoch, micro_step, skip)
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
                sampler.set_epoch(epoch)
                epoch_iter = iter(sampler)
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
                    if micro_step % (self.log_interval * k) == 0:
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
                        anchor = (epoch + 1, micro_step, skip)
                    continue
                break
        except KeyboardInterrupt:
            # the batches consumed this epoch: those skipped on entry plus the
            # micro-steps applied since, counted from the state
            a_epoch, a_micro, a_skip = anchor
            epoch_batch = (a_skip - skip) + (state.step - a_micro)
            log.warning("interrupted at micro-step %d; saving a checkpoint", state.step)
            self._save_ckpt(state.step // k, state, a_epoch, epoch_batch)
            raise
        finally:
            if installed:  # a disposition set outside Python reads as None
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None else signal.SIG_DFL)

        final_step = state.step // k
        ckpts = list_checkpoints(self.work_dir)
        if not ckpts or final_step > ckpts[-1][0]:
            self._save_ckpt(final_step, state, anchor[0], epoch_batch)
        return state

    def _save_ckpt(self, step: int, state: TrainState, epoch: int, epoch_batch: int) -> None:
        self.ckpt_manager.save(
            step, state.model.state_dict(), state.optimizer.state_dict(), state.accumulator,
            extra_meta={"micro_step": state.step, "epoch": epoch, "epoch_batch": epoch_batch})

    # ---- validation ----
    def _validate(self, state: TrainState, valid_ds, val_sampler,
                  limit: Optional[int] = None) -> dict:
        loss_sums: dict = {}
        weight_sum = acc_correct = acc_total = 0
        for batch_idx, idx_list in enumerate(val_sampler):
            if limit is not None and batch_idx >= limit:
                break
            batch = self.task.collate([valid_ds[i] for i in idx_list])
            losses, extras = self.task.valid_step(state, batch)
            for key, value in losses.items():
                loss_sums[key] = loss_sums.get(key, 0.0) + float(value) * len(idx_list)
            weight_sum += len(idx_list)
            if "midi_acc_correct" in extras:
                acc_correct += int(extras["midi_acc_correct"])
                acc_total += int(extras["midi_acc_total"])
        means = {key: v / weight_sum for key, v in loss_sums.items()} if weight_sum else {}
        if means:
            self._log_scalars("validation", means, state.step)
            if acc_total:
                means["midi_acc"] = acc_correct / acc_total
                self._log_scalars("metrics", {"midi_acc": means["midi_acc"]}, state.step)
            log.info("validation @ %d | %s", state.step,
                     " ".join(f"{key}={v:.5g}" for key, v in means.items()))
        self.last_validation = means
        return means
