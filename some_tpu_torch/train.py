"""Training CLI: config cascade -> task -> trainer with auto-resume.

Counterpart of the JAX package's ``train.py``, with the same flags and the
same work-directory layout: the frozen ``config.yaml``, step-named
checkpoints (which ``python -m some_tpu_torch.infer --model`` reads as they
are), and TensorBoard event files when tensorboardX imports. Runs on the GPU
unless ``--device cpu``.

    python -m some_tpu_torch.train --config configs/midi_conformer.yaml \\
        --exp_name NAME [--work_dir DIR] [--max_steps N] [--device cpu]
"""
from __future__ import annotations

import argparse
import logging
import pathlib
import sys

from some_tpu_torch.config import print_config, read_full_config, save_yaml
from some_tpu_torch.training.me_quant_task import QuantizedMIDIExtractionTask
from some_tpu_torch.training.me_task import MIDIExtractionTask

# task_cls, under the JAX package's names (some_tpu/registry.py) -> the task
TASKS = {
    "training.MIDIExtractionTask": MIDIExtractionTask,
    "some_tpu.training.me_task.MIDIExtractionTask": MIDIExtractionTask,
    "training.QuantizedMIDIExtractionTask": QuantizedMIDIExtractionTask,
    "some_tpu.training.me_quant_task.QuantizedMIDIExtractionTask": QuantizedMIDIExtractionTask,
}


def build_task(config: dict, device=None) -> MIDIExtractionTask:
    if config["task_cls"] not in TASKS:
        raise ValueError(f"no training task for {config['task_cls']!r}")
    return TASKS[config["task_cls"]](config, device=device)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a SOME model with some_tpu_torch")
    parser.add_argument("--config", required=True, metavar="FILE",
                        help="path to the configuration file")
    parser.add_argument("--exp_name", required=True, metavar="EXP", help="experiment name")
    parser.add_argument("--work_dir", metavar="DIR",
                        help="directory that holds the experiment (default ./experiments)")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="override max_updates (smoke runs)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; cpu runs the plain versions)")
    args = parser.parse_args(argv)
    logging.basicConfig(stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s %(message)s", datefmt="%m/%d %I:%M:%S %p")

    from some_tpu_torch.training.trainer import Trainer

    config = read_full_config(pathlib.Path(args.config))
    print_config(config)
    work_dir = pathlib.Path(args.work_dir) if args.work_dir else pathlib.Path("experiments")
    work_dir = work_dir / args.exp_name
    if work_dir.exists() and not work_dir.is_dir():
        raise NotADirectoryError(f"Path '{work_dir}' is not a directory.")
    work_dir.mkdir(parents=True, exist_ok=True)
    save_yaml(config, work_dir / "config.yaml")
    config["work_dir"] = str(work_dir)

    task = build_task(config, device=args.device)
    log_writer = None
    try:
        from tensorboardX import SummaryWriter
        log_writer = SummaryWriter(logdir=str(work_dir / "lightning_logs" / "lastest"))
    except ImportError:
        pass
    Trainer(task, work_dir, log_writer=log_writer).fit(max_steps=args.max_steps)


if __name__ == "__main__":
    main()
