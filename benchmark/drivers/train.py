"""Training steps: the port's ``Trainer.fit`` step loop on a seeded set.

Set-up: a set of about ``hours`` of seeded items in memory (log-mel units,
pitch, notes; the item lengths one fixed set of log-normal quantiles, the
seed ordering them and drawing the rest); the task (``train.build_task``)
with seeded weights made on the card in place of its initialiser; each
batch shape that the sampler's first epochs yield visited twice (the first
runs eagerly, the second captures its graph); the state put back in place
to its start (the seed's weights and buffers, AdamW's moments and step
count zero, no step taken: the graphs read these very tensors); then its
first ``check_steps`` steps through ``Trainer.fit`` itself (its sampler,
its prefetch thread, its collate and copies), each a replay of a captured
graph as in the window, the numbers the check compares read from that
state after them.

Window: ``Trainer.fit`` again on the same state for ``--seconds``; every
train step is timed by the host clock and the card is synchronised at the
close. ``train_frames_per_s``: the real frames of every step finished in
the window over its seconds.

Check: the plain reference (``reference/train.py``) runs the first steps
from the same weights on the same items in float32 and is compared with the
program's first update's gradient norms (from AdamW's first moments) and its
parameters' change after the steps, leaf by leaf; the losses' gap is read
beside them. The numbers compared are those of ``limits/<cell>.json``, and
``steps_not_replayed`` (limit 0): the checked steps that did not replay a
graph (on the CPU, where every step runs eagerly: that did not run
eagerly).
"""
from __future__ import annotations

import gc
import math
import sys
import tempfile
import threading
import time

import numpy as np

from benchmark.harness.readers import coverage_line
from benchmark.harness.trace import (
    TRACE_LEAD, TRACE_MAX_S, DeviceTrace, Phases, Spans, breakdown, hold,
)
from benchmark.harness.weights import make_weights
from benchmark.reference import train as RT

#: leaves whose reference gradient is under this share of the median leaf's
#: move by round-off alone under Adam: left out of the leaf comparisons
NOUGHT_GRAD = 1e-3


class WindowClosed(Exception):
    """Raised from the step loop when the window's time is up."""


def item_lengths(mix: dict, sr: int, hop: int) -> list:
    """Frames of each item: the quantiles of a log-normal law (median,
    sigma) clipped to [min, max] seconds, as many as fill ``hours``."""
    from statistics import NormalDist

    def lengths(n):
        z = [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
        median, sigma = mix["item_median_s"], mix["item_sigma"]
        return [min(mix["item_max_s"], max(mix["item_min_s"], median * math.exp(sigma * v)))
                for v in z]

    mean = sum(lengths(1000)) / 1000
    n = max(1, int(round(mix["hours"] * 3600 / mean)))
    return [int(s * sr / hop) + 1 for s in lengths(n)]


def make_items(seed: int, frames: list, n_mels: int, device) -> list:
    """Seeded items of the given frame counts, in the seed's order: units
    drawn on the card in one call, notes of about 0.3 s on the host."""
    import torch

    rng = np.random.default_rng([int(seed), 6])
    frames = [frames[i] for i in rng.permutation(len(frames))]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    total = sum(frames)
    units = (torch.randn(total, n_mels, generator=gen, device=device) * 2.0 - 5.0).cpu().numpy()
    pitch = rng.uniform(40, 80, total).astype(np.float32)
    items, pos = [], 0
    for t in frames:
        n = max(1, t // 26)
        dur = rng.multinomial(t - n, np.ones(n) / n) + 1
        items.append({"units": units[pos:pos + t], "pitch": pitch[pos:pos + t],
                      "note_midi": rng.uniform(40, 80, n).astype(np.float32),
                      "note_rest": rng.random(n) < 0.2, "note_dur": dur.astype(np.int64),
                      "unit2note": np.repeat(np.arange(1, n + 1), dur).astype(np.int64)})
        pos += t
    return items


def _shape(batch: dict) -> tuple:
    return tuple(sorted((k, tuple(v.shape)) for k, v in batch.items() if hasattr(v, "shape")))


def restart(state, weights: dict, buffers: dict) -> None:
    """The state back at its start, in place (the captured graphs read these
    very tensors): the seed's weights and buffers, the optimizer's moments
    and step counts zero (as AdamW makes them at its first step), no step
    taken."""
    import torch

    with torch.no_grad():
        for name, p in state.model.named_parameters():
            p.copy_(weights[name])
        for name, b in state.model.named_buffers():
            b.copy_(buffers[name])
        for slot in state.optimizer.state.values():
            for value in slot.values():
                if isinstance(value, torch.Tensor):
                    value.zero_()
    state.step = 0


def run(ctx) -> dict:
    import torch

    import some_tpu_torch.training.base_task as base_task
    from some_tpu_torch.data.sampler import BucketBatchSampler
    from some_tpu_torch.train import build_task
    from some_tpu_torch.training.trainer import Trainer

    cfg = dict(ctx.config, seed=int(ctx.seed))
    mix, device = ctx.mix, torch.device(ctx.device)
    sr, hop = cfg["audio_sample_rate"], cfg["hop_size"]
    phases = Phases(ctx.t_start)
    frames = item_lengths(mix, sr, hop)
    items = make_items(ctx.seed, frames, cfg["units_dim"], device)
    valid = make_items(ctx.seed + 1, [int(5.0 * sr / hop) + 1] * 2, cfg["units_dim"], device)
    sizes = np.array([len(it["units"]) for it in items])
    phases.done(f"{len(items)} items, {sizes.sum()} frames")

    weights = make_weights(cfg, ctx.seed, device)
    host_weights = {k: v.cpu() for k, v in weights.items()}
    del weights
    task = build_task(cfg, device=device)
    task.load_datasets = lambda: ((items, sizes), (valid, np.array([len(v["units"])
                                                                    for v in valid])))
    original_init = base_task.init_model
    base_task.init_model = lambda model, *a, **k: model.load_state_dict(host_weights)
    try:
        state = task.init_state()
    finally:
        base_task.init_model = original_init
    if ctx.fault is not None:  # the tests' broken timed path
        ctx.fault(task)
    phases.done("weights and task")

    # every batch shape of the first epochs: a first visit and a capture,
    # then the state back at its start, so the checked steps replay
    buffers = {name: b.detach().clone() for name, b in state.model.named_buffers()}
    inner = task.train_step
    sampler = BucketBatchSampler(
        sizes=sizes, max_batch_frames=cfg["max_batch_frames"],
        max_batch_size=cfg["max_batch_size"],
        frame_count_grid=cfg.get("sampler_frame_count_grid", 6),
        required_batch_count_multiple=cfg.get("accumulate_grad_batches", 1),
        sort_by_similar_size=cfg.get("sort_by_len", True), shuffle=True, seed=cfg["seed"])
    shapes = {}
    for epoch in range(int(mix["warm_epochs"])):
        sampler.set_epoch(epoch)
        for idx in sampler:
            shapes.setdefault(_shape(task.collate([items[i] for i in idx])), idx)
    for idx in shapes.values():
        batch = task.collate([items[i] for i in idx])
        for _ in range(2):
            inner(state, batch)
    restart(state, host_weights, buffers)
    if device.type == "cuda":
        torch.cuda.synchronize()
    phases.done(f"{len(shapes)} batch shapes visited twice, the state restarted")

    work = tempfile.TemporaryDirectory(prefix="bench-train-")
    trainer = Trainer(task, work.name)
    trainer.restore_or_init = lambda: state
    trainer._save_ckpt = lambda *a, **k: None  # no checkpoint falls in a run
    batches_seen = []
    prepared = trainer._prepared_batches

    def recording(epoch_iter, train_ds):
        for idx_list, batch in prepared(epoch_iter, train_ds):
            batches_seen.append(list(idx_list))
            yield idx_list, batch

    trainer._prepared_batches = recording
    readings = {"losses": [], "dispatch": []}
    n_check = int(mix["check_steps"])

    def checked_step(st, batch):
        logs = inner(st, batch)
        readings["losses"].append(logs["total_loss"])
        readings["dispatch"].append(task.last_dispatch)
        if st.step == 1:  # AdamW's first moment after one update: (1 - beta1) g
            b1 = float(cfg["optimizer_args"].get("beta1", 0.9))
            readings["grad_norms"] = {
                name: float(st.optimizer.state[p]["exp_avg"].norm()) / (1 - b1)
                if "exp_avg" in st.optimizer.state[p] else 0.0
                for name, p in st.model.named_parameters()}
        if st.step == n_check:
            readings["changes"] = {
                name: float((p.detach() - host_weights[name].to(p.device)).norm())
                for name, p in st.model.named_parameters()}
        return logs

    task.train_step = checked_step
    trainer.fit(max_steps=n_check)
    readings["losses"] = [float(x) for x in readings["losses"]]
    if device.type == "cuda":
        torch.cuda.synchronize()
    phases.done(f"{n_check} checked steps through Trainer.fit "
                f"({', '.join(map(str, readings['dispatch']))})")

    # ---- the window ----
    spans, steps, dispatch = Spans(), [], {}
    tracer = None
    if ctx.trace and device.type == "cuda":
        # the prefetch thread copies batches to the card: the profiler
        # starts and stops between two of its copies
        gate = threading.Lock()
        hold(task, "to_device", gate)
        tracer = DeviceTrace(gate)
        tracer.warm()
    print(phases.line(), file=sys.stderr)
    t0 = time.monotonic()
    setup_s = t0 - ctx.t_start
    t_end = t0 + ctx.seconds
    trace_at = t0 + TRACE_LEAD * ctx.seconds

    def timed_step(st, batch):
        nonlocal tracer
        start = time.monotonic()
        if tracer is not None and tracer.t0 is None and start >= trace_at:
            tracer.start()
            start = tracer.t0  # this step's work is the stretch's first
        logs = inner(st, batch)
        now = time.monotonic()
        dispatch[task.last_dispatch] = dispatch.get(task.last_dispatch, 0) + 1
        spans.add("trainer: train_step (host)", start, now)
        rows, t_pad = batch["mask"].shape
        real = np.zeros(rows, np.int64)  # from the host's items: no wait for the card
        real[:len(batches_seen[-1])] = sizes[batches_seen[-1]]
        steps.append((start, int(rows), int(t_pad), real))
        if tracer is not None and tracer.t0 is not None and tracer.t1 is None and (
                now >= tracer.t0 + TRACE_MAX_S):
            tracer.stop()
        if now >= t_end:
            raise WindowClosed
        return logs

    task.train_step = timed_step
    try:
        trainer.fit(max_steps=10 ** 9)
    except WindowClosed:
        pass
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_close = time.monotonic()
    if tracer is not None and tracer.t1 is None and tracer.t0 is not None:
        tracer.stop()
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    real = sum(int(s[3].sum()) for s in steps)
    e2e = {"setup_s": setup_s, "train_frames_per_s": real / (t_close - t0)}
    print(f"| window: {len(steps)} steps ({dispatch}), {real} real frames in "
          f"{t_close - t0:.3f} s", file=sys.stderr)
    obs = {"window_s": t_close - t0, "config": cfg, "steps": steps, "trace": None}
    out = {"e2e": e2e, "attempted": len(steps), "failed": 0, "memory_peak_bytes": memory_peak,
           "obs": obs}
    if tracer is not None and tracer.t1 is not None:
        reduced = tracer.reduce(spans)
        reduced["steps"] = [s for s in steps if tracer.t0 <= s[0] <= tracer.t1]
        obs["trace"] = reduced
        print(coverage_line(obs), file=sys.stderr)
        out["breakdown"] = breakdown(reduced)
        out["busy_s"], out["window_s"] = reduced["busy_s"], reduced["window_s"]

    # ---- the check: the program freed, the reference on the first steps ----
    del state, trainer, task
    work.cleanup()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    out["checks"] = _check(ctx, readings, batches_seen[:n_check], items, host_weights, device)
    on_path = "replay" if device.type == "cuda" else "eager"
    out["checks"].append(("steps_not_replayed",
                          sum(d != on_path for d in readings["dispatch"]), 0))
    print(f"| check: {n_check} reference steps in {time.monotonic() - t_check:.2f} s",
          file=sys.stderr)
    return out


def compare(program: dict, ref: dict) -> dict:
    """The compared numbers: the worst step's relative loss gap; by the
    worst leaf, the gap between the program's and the reference's norm of
    the first clipped gradient, and of the change after the steps, each
    over the larger of that leaf's reference norm and the median leaf's.
    Leaves whose reference gradient is nought to rounding are left out."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(program["losses"], ref["losses"]))
    g = ref["grad_norms"]
    median_g = float(np.median(list(g.values())))
    kept = [k for k in g if g[k] >= NOUGHT_GRAD * median_g]
    out = {"loss_gap": loss}
    for key, name in (("grad_norms", "grad_norm_gap"), ("changes", "change_gap")):
        r = ref[key]
        median = float(np.median([r[k] for k in kept]))
        out[name] = max(abs(program[key][k] - r[k]) / max(r[k], median) for k in kept)
    out["leaves_left_out"] = len(g) - len(kept)
    return out


def _check(ctx, readings, batches, items, host_weights, device):
    import torch

    from benchmark.reference.model import exact_f32

    cfg = ctx.judge_config
    padded = [RT.pad_batch([items[i] for i in idx], int(cfg.get("frame_bucket_grid", 128)))
              for idx in batches]
    with exact_f32():
        ref = RT.train_steps(host_weights, padded, cfg, int(ctx.seed), device)
        numbers = compare(readings, ref)
        if ctx.control:
            control = RT.train_steps(host_weights, padded, cfg, int(ctx.seed), device,
                                     quant="fp8")
            ctx.readings["control"] = compare(control, ref)
    ctx.readings["program"] = numbers
    # loss_gap is read, not compared: no control or fault reads three (ten)
    # times its sound runs' largest (PERF.md)
    return [(name, numbers[name], ctx.limits[name]) for name in ctx.limits]
