"""Faults planted in the program's timed path, by name: what the check must
catch (``tests/test_bench_control.py`` on the CPU, ``control.py --fault``
on the card at the cell's own size). Each takes the program's engine
(served cells) or task (training) once built."""
from __future__ import annotations

import numpy as np


def note_up(engine) -> None:
    """An answer altered where it is made: every note a semitone up."""
    assemble = engine.assemble

    def altered(device_out, n_frames):
        notes = assemble(device_out, n_frames)
        notes["note_midi"] = notes["note_midi"] + np.float32(1.0)
        return notes

    engine.assemble = altered


def half_left_out(engine) -> None:
    """Half of each dispatched batch left out: every second chunk answered
    with no notes."""
    infer = engine.infer

    def half(waveforms):
        out = infer(waveforms)
        return [notes if i % 2 == 0 else {k: v[:0] for k, v in notes.items()}
                for i, notes in enumerate(out)]

    engine.infer = half


def state_unchanged(task) -> None:
    """Every step computes its gradients and leaves the state as it was."""
    def no_update(state, named, norm=None):
        for _, p in named:
            p.grad = None

    task._apply = no_update


def half_batch(task) -> None:
    """Every step trains on the first half of its rows, the mean taken over
    them."""
    step = task.train_step

    def halved(state, batch):
        batch = dict(batch)
        rows = batch["batch_mask"]
        keep = rows.clone() if hasattr(rows, "clone") else rows.copy()
        keep[(len(keep) + 1) // 2:] = False
        batch["batch_mask"] = keep
        return step(state, batch)

    task.train_step = halved


FAULTS = {f.__name__: f for f in (note_up, half_left_out, state_unchanged, half_batch)}
