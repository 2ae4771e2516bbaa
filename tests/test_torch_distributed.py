"""Two training processes (gloo, on the CPU) against one process on the
global batch.

tests/test_training.py's TINY_CONFIG (1 layer, dim 32, 2 x 16 heads, k 7,
f32) with dropout 0.1 and BatchNorm training, on an HDF5 set whose items
vary in length, so that the two ranks hold different numbers of real rows
and frames in a step. Two processes of tests/torch_dist_worker.py join one
group through the SOME_TPU_COORDINATOR contract and run the port's Trainer
for 2 updates, validating and writing a checkpoint at the second. Held:
  * each rank trained on its own batches of the sampler, padded to the
    step's common shapes; their parameters are bit-identical after each
    run;
  * one process taking train_step on the concatenation of the two ranks'
    batches (the global batch) ends at the same parameters and BatchNorm
    statistics within 2e-6 + 2e-6 |want| (f32: the global sums are two
    partial sums added, in another order), from the same initial weights.
    The depthwise biases are held apart: the BatchNorm right after the conv
    removes any per-channel constant, so their gradient is 0 in exact
    arithmetic and float noise in both runs, which AdamW turns into steps
    of about the lr either way; they are held within 3 x the two updates'
    lr, and the running means that see them within a tenth of that (one
    update of momentum 0.9 after the first step);
  * process 0 alone wrote the checkpoint, and it holds those parameters;
  * both ranks' validation means are equal, and equal one process's
    validation of the same weights.
The whole two-process run has 120 s.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from some_tpu_torch.data.indexed_dataset import IndexedDatasetWriter, save_lengths
from some_tpu_torch.training.me_task import MIDIExtractionTask
from some_tpu_torch.training.trainer import Trainer
from tests.test_training import TINY_CONFIG, make_item

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_dist_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dataset(path: pathlib.Path) -> pathlib.Path:
    rng = np.random.default_rng(31)
    # the sampler gives rank 0 four rows of 20-35 frames and rank 1 three of
    # 52-70 in the first step
    for prefix, lengths in (("train", [20, 118, 35, 52, 96, 61, 110, 24, 83, 70, 35, 100]),
                            ("valid", [57, 90, 66])):
        with IndexedDatasetWriter(path, prefix) as writer:
            for n in lengths:
                writer.add_item(make_item(rng, n, int(rng.integers(3, 8))))
        save_lengths(path, prefix, lengths)
    return path


def _config(data_dir):
    return dict(TINY_CONFIG, binary_data_dir=str(data_dir), ds_workers=0,
                max_batch_frames=250, max_batch_size=4, val_check_interval=2,
                num_sanity_val_steps=0, max_val_batch_size=2)


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    config = _config(_dataset(tmp / "binary"))
    (tmp / "config.json").write_text(json.dumps(config))
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, SOME_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   SOME_TPU_NUM_PROCESSES="2", SOME_TPU_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(tmp / "config.json"), str(tmp / "work"),
             str(tmp / f"rank{rank}.pt"), "2"],
            env=env, cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"--- rank {i} ---\n{log[-3000:]}" for i, log in enumerate(logs))
    runs = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return config, tmp, runs


def test_ranks_hold_different_rows_and_frames(two_process_run):
    config, _, runs = two_process_run
    assert [r["joined"] for r in runs] == [True, True]
    assert [(r["rank"], r["world"]) for r in runs] == [(0, 2), (1, 2)]
    assert all(all(r["sync"]) and r["sync"] for r in runs)
    assert runs[0]["step"] == runs[1]["step"] == 2
    differ = False
    for a, b in zip(runs[0]["batches"], runs[1]["batches"]):
        # one shape for the step on both ranks, from the sampler alone
        assert {k: np.shape(v) for k, v in a.items()} == {k: np.shape(v) for k, v in b.items()}
        assert a["t_real"][0] == b["t_real"][0]
        differ |= (a["batch_mask"].sum() != b["batch_mask"].sum()
                   and a["mask"].sum() != b["mask"].sum())
    assert differ, "the data gives both ranks the same numbers of rows and frames"
    # each rank read its own batches: the sampler's partition
    from some_tpu_torch.data.sampler import BucketBatchSampler

    sizes = np.load(pathlib.Path(config["binary_data_dir"]) / "train.lengths")
    for rank, run in enumerate(runs):
        sampler = BucketBatchSampler(
            sizes=sizes, max_batch_frames=config["max_batch_frames"],
            max_batch_size=config["max_batch_size"], num_replicas=2, rank=rank,
            frame_count_grid=config["sampler_frame_count_grid"], shuffle=True,
            seed=config["seed"])
        want = [i for b in sampler.form_batches()[:2] for i in b]
        assert run["items"] == want


def test_two_processes_equal_one_process_on_the_global_batch(two_process_run):
    config, tmp, runs = two_process_run
    for key, value in runs[0]["final"].items():
        assert torch.equal(value, runs[1]["final"][key]), key  # bit-identical ranks
        assert torch.equal(runs[0]["init"][key], runs[1]["init"][key]), key
    task = MIDIExtractionTask(dict(config), device="cpu")
    state = task.init_state()
    state.model.load_state_dict(runs[0]["init"])
    for a, b in zip(runs[0]["batches"], runs[1]["batches"]):
        glob = {}
        for key, va in a.items():
            if key in ("size", "real_frames"):
                glob[key] = va + b[key]
            elif key == "t_real":
                glob[key] = va
            else:
                glob[key] = np.concatenate([va, b[key]])
        task.train_step(state, glob)
    want = state.model.state_dict()
    lr_sum = task.schedule(0) + task.schedule(1)
    for key, value in runs[0]["final"].items():
        atol = (3 * lr_sum if key.endswith("conv.dw.bias")
                else 0.3 * lr_sum if key.endswith("conv.bn.running_mean") else 2e-6)
        torch.testing.assert_close(value, want[key], atol=atol, rtol=2e-6, msg=key)
    moved = sum(not torch.equal(runs[0]["final"][k], runs[0]["init"][k]) for k in want)
    assert moved > 50
    # the one checkpoint, process 0's, holds the final weights
    from some_tpu_torch.utils.checkpoint import load_checkpoint

    ckpts = sorted(p.name for p in (tmp / "work").glob("*.ckpt"))
    assert ckpts == ["model_ckpt_steps_2.ckpt"]
    saved = load_checkpoint(tmp / "work" / ckpts[0])
    assert saved["meta"]["micro_step"] == 2
    for key, value in saved["state_dict"].items():
        assert torch.equal(value, runs[0]["final"][key]), key


def test_validation_means_equal_one_process(two_process_run):
    config, tmp, runs = two_process_run
    assert runs[0]["validation"] == runs[1]["validation"]
    assert "midi_acc" in runs[0]["validation"]
    task = MIDIExtractionTask(dict(config), device="cpu")
    trainer = Trainer(task, tmp / "one")
    state = task.init_state()
    state.model.load_state_dict(runs[0]["final"])
    (_, _), (valid_ds, valid_sizes) = task.load_datasets()
    from some_tpu_torch.data.sampler import EvalBatchSampler

    sampler = EvalBatchSampler(valid_sizes, config["max_val_batch_frames"],
                               config["max_val_batch_size"])
    means = trainer._validate(state, valid_ds, sampler)
    assert set(means) == set(runs[0]["validation"])
    for key, value in means.items():
        assert runs[0]["validation"][key] == pytest.approx(value, rel=1e-6, abs=1e-7), key
