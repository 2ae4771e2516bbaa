"""Training checkpoints: step-named files with top-k and permanent retention.

Counterpart of ``some_tpu/training/checkpoint.py``. A training checkpoint is
``model_ckpt_steps_{step}.ckpt``, written and read by ``utils/checkpoint.py``
(the one place that knows the format), so ``some_tpu_torch.infer`` loads it
as it is.
"""
from __future__ import annotations

import pathlib
import re
from typing import Optional

from some_tpu_torch.utils.checkpoint import save_checkpoint

CKPT_RE = re.compile(r"model_ckpt_steps_(\d+)\.ckpt$")


def checkpoint_path(work_dir: pathlib.Path | str, step: int) -> pathlib.Path:
    return pathlib.Path(work_dir) / f"model_ckpt_steps_{step}.ckpt"


def list_checkpoints(work_dir: pathlib.Path | str):
    work_dir = pathlib.Path(work_dir)
    if not work_dir.exists():
        return []
    found = []
    for p in work_dir.glob("model_ckpt_steps_*.ckpt"):
        m = CKPT_RE.search(p.name)
        if m:
            found.append((int(m.group(1)), p))
    return sorted(found)


def latest_checkpoint(work_dir: pathlib.Path | str) -> Optional[pathlib.Path]:
    ckpts = list_checkpoints(work_dir)
    return ckpts[-1][1] if ckpts else None


class CheckpointManager:
    """Keep the newest ``keep_top_k`` checkpoints, and every checkpoint on
    the permanent schedule (step >= permanent_start, a multiple of
    permanent_interval past it; on only when start > 0 and interval > 9, the
    reference's guard)."""

    def __init__(self, work_dir: pathlib.Path | str, keep_top_k: int = 5,
                 permanent_start: int = 0, permanent_interval: int = 0):
        self.work_dir = pathlib.Path(work_dir)
        self.keep_top_k = keep_top_k
        self.permanent_start = permanent_start or 0
        self.permanent_interval = permanent_interval or 0
        self.enable_permanent = self.permanent_start > 0 and self.permanent_interval > 9

    def is_permanent(self, step: int) -> bool:
        return (self.enable_permanent and step >= self.permanent_start
                and (step - self.permanent_start) % self.permanent_interval == 0)

    def save(self, step: int, state_dict, optimizer=None, accumulator=None,
             extra_meta: dict | None = None) -> pathlib.Path:
        path = save_checkpoint(checkpoint_path(self.work_dir, step), state_dict,
                               {"step": step, **(extra_meta or {})}, optimizer, accumulator)
        self.prune()
        return path

    def prune(self) -> None:
        deletable = [(s, p) for s, p in list_checkpoints(self.work_dir)
                     if not self.is_permanent(s)]
        while len(deletable) > self.keep_top_k:
            deletable.pop(0)[1].unlink(missing_ok=True)
