"""The trainer's profile window and the tracing helpers, on the CPU.

TINY_CONFIG (1 layer, dim 32, f32, dropout 0.1) on a small HDF5 set, one
process. With ``profile_dir`` and ``log_interval: 2`` the trainer takes one
extra, traced step on the batch of update 2, as the JAX trainer does
(``some_tpu/training/trainer.py``: the step counts, the batch does not):
  * the window writes a torch.profiler trace that holds the step's ops;
  * a run interrupted inside the window (the traced step raises before it
    applies) saves a checkpoint whose sampler position makes the resumed run
    apply the same batches in the same order as an uninterrupted run with
    the window, and end at the same weights bit for bit;
  * ``trace`` alone writes one trace file of the block's ops.
"""
import json

import pytest
import torch

from some_tpu_torch.training.me_task import MIDIExtractionTask
from some_tpu_torch.training.trainer import Trainer
from some_tpu_torch.utils.checkpoint import load_checkpoint
from some_tpu_torch.utils import profiling
from some_tpu_torch.utils.profiling import trace
from tests.test_torch_train import tiny_dataset  # noqa: F401  (a fixture)
from tests.test_training import TINY_CONFIG


class RecordingTask(MIDIExtractionTask):
    """Records the first item of each batch it trains on, and raises
    KeyboardInterrupt at its ``stop_at``-th train step, before applying it."""

    def __init__(self, config, applied, stop_at=None):
        super().__init__(dict(config), device="cpu")
        self.applied, self.stop_at, self.calls = applied, stop_at, 0

    def train_step(self, state, batch):
        self.calls += 1
        if self.calls == self.stop_at:
            raise KeyboardInterrupt("inside the profile window")
        self.applied.append(float(batch["units"][0, 0, 0]))
        return super().train_step(state, batch)


def _config(tiny_dataset, tmp_path, window=True):
    config = dict(TINY_CONFIG, ds_workers=0, binary_data_dir=str(tiny_dataset), log_interval=2,
                  val_check_interval=100)
    if window:
        config["profile_dir"] = str(tmp_path / "profile")
    return config


def test_window_writes_a_trace(tiny_dataset, tmp_path):  # noqa: F811
    config = _config(tiny_dataset, tmp_path)
    applied = []
    trainer = Trainer(RecordingTask(config, applied), tmp_path / "w")
    state = trainer.fit(max_steps=4)
    # updates 1 and 2, the traced repeat of update 2's batch, then update 4
    assert state.step == 4 and len(applied) == 4 and applied[1] == applied[2]
    traces = list((tmp_path / "profile").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names) and "aten::mm" in names
    meta = load_checkpoint(tmp_path / "w" / "model_ckpt_steps_4.ckpt")["meta"]
    assert meta["micro_step"] == 4 and _consumed(trainer, config, meta) == 3  # three batches


class MaskTask(MIDIExtractionTask):
    """Keeps each train step's real frames, read from its mask."""

    def __init__(self, config):
        super().__init__(dict(config), device="cpu")
        self.real = []

    def train_step(self, state, batch):
        self.real.append(int(batch["mask"].sum()))
        return super().train_step(state, batch)


@pytest.mark.parametrize("workers", [0, 1])
def test_fit_records_its_data_wait_and_step_parts(tiny_dataset, tmp_path, workers):  # noqa: F811
    """A short fit with ``trace_out``: the loop's wait for each batch (on
    the prefetch thread's queue, or the read inline at ``ds_workers`` 0),
    the prefetch parts, each step's parts with its real (counted on the
    host by ``to_device``) and padded frames, the log read, the validation
    and the checkpoint at update 2, all in the Chrome trace written when
    the fit ends."""
    config = dict(_config(tiny_dataset, tmp_path, window=False), ds_workers=workers,
                  val_check_interval=2, trace_out=str(tmp_path / "fit.trace.json"))
    task = MaskTask(config)
    Trainer(task, tmp_path / "w").fit(max_steps=3)
    assert not profiling.recording()
    spans = profiling.snapshot()["spans"]
    named = {}
    for s in spans:
        named.setdefault(s["name"], []).append(s)
    waits = named["trainer: wait for batch"]
    assert len(waits) >= 3 and {s["thread"] for s in waits} == {"MainThread"}
    feeder = "some_tpu_torch-prefetch" if workers else "MainThread"
    wait_ids = {s["id"] for s in waits}
    for part in ("prefetch: read", "prefetch: collate", "prefetch: to_device"):
        assert {s["thread"] for s in named[part]} == {feeder}
        assert all((s["parent"] in wait_ids) == (not workers) for s in named[part])
    steps = named["task: train_step"]
    assert len(steps) == 3 and {s["attrs"]["dispatch"] for s in steps} == {"eager"}
    step_ids = {s["id"] for s in steps}
    parts = {s["name"] for s in spans if s["parent"] in step_ids} - {"python: gc"}
    assert parts == {"task: prepare", "task: eager"}
    assert [s["attrs"]["real_frames"] for s in steps] == task.real and sum(task.real) > 0
    for s in steps:
        assert s["attrs"]["real_frames"] <= s["attrs"]["rows"] * s["attrs"]["frames"]
    for name in ("trainer: log", "trainer: validate", "trainer: checkpoint"):
        assert len(named[name]) >= 1, name
    events = json.loads((tmp_path / "fit.trace.json").read_text())["traceEvents"]
    written = {e["name"] for e in events if e.get("ph") == "X"}
    assert set(named) <= written


def _consumed(trainer, config, meta) -> int:
    """The batches a checkpoint's (epoch, epoch_batch) says were consumed."""
    from some_tpu_torch.data.sampler import BucketBatchSampler

    _, sizes = trainer.task.load_datasets()[0]
    sampler = BucketBatchSampler(sizes=sizes, max_batch_frames=config["max_batch_frames"],
                                 max_batch_size=config["max_batch_size"],
                                 frame_count_grid=config["sampler_frame_count_grid"],
                                 shuffle=True, seed=config["seed"])
    done = 0
    for epoch in range(meta["epoch"]):
        sampler.set_epoch(epoch)
        done += len(sampler)
    return done + meta["epoch_batch"]


@pytest.mark.parametrize("stop_at", [3, 4])
def test_interrupt_inside_the_window_resumes_in_order(tiny_dataset, tmp_path, stop_at):  # noqa: F811
    """stop_at 3: inside the traced step; 4: the step after the window."""
    config = _config(tiny_dataset, tmp_path)
    straight = []
    want = Trainer(RecordingTask(config, straight), tmp_path / "a").fit(max_steps=5)

    resumed = []
    with pytest.raises(KeyboardInterrupt):
        Trainer(RecordingTask(config, resumed, stop_at=stop_at), tmp_path / "b").fit(max_steps=5)
    assert not torch.autograd._profiler_enabled()  # the window closed its profiler
    state = Trainer(RecordingTask(config, resumed), tmp_path / "b").fit(max_steps=5)
    assert resumed == straight
    assert state.step == want.step == 5
    for key, value in want.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[key], value), key


def test_trace_records_the_block(tmp_path):
    with trace(str(tmp_path / "t")):
        torch.ones(8) @ torch.ones(8)
    traces = list((tmp_path / "t").glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert any("dot" in str(n) or "matmul" in str(n) for n in names), sorted(map(str, names))[:20]
