"""One process of tests/test_torch_distributed.py's two-process run.

Joins the gloo group through the SOME_TPU_COORDINATOR contract (the
parent sets it), trains with the port's Trainer on the CPU, and saves what
the parent holds against one process: the initial and final weights, each
batch this process trained on, the validation means and the data order.
Imports the port and numpy only.

    python tests/torch_dist_worker.py CONFIG.json WORK_DIR OUT.pt STEPS
"""
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(config_path, work_dir, out_path, steps):
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from some_tpu_torch.parallel import distributed as dist
    from some_tpu_torch.training.me_task import MIDIExtractionTask
    from some_tpu_torch.training.trainer import Trainer

    joined = dist.maybe_initialize("cpu")
    config = json.loads(pathlib.Path(config_path).read_text())
    record = {"batches": [], "items": []}

    class RecordingTask(MIDIExtractionTask):
        def init_state(self, seed=None):
            state = super().init_state(seed)
            record["init"] = {k: v.clone() for k, v in state.model.state_dict().items()}
            return state

        def train_step(self, state, batch):
            record["batches"].append({k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                                          else v) for k, v in batch.items()})
            return super().train_step(state, batch)

        def load_datasets(self):
            (tds, tsz), valid = super().load_datasets()

            class _Wrap:
                def __getitem__(self, i):
                    record["items"].append(int(i))
                    return tds[i]

                def attr_length(self, i, key):
                    return tds.attr_length(i, key)

            return (_Wrap(), tsz), valid

    trainer = Trainer(RecordingTask(config, device="cpu"), work_dir)
    state = trainer.fit(max_steps=int(steps))
    record.update(joined=joined, rank=dist.rank(), world=dist.world_size(), step=state.step,
                  final=state.model.state_dict(), validation=trainer.last_validation,
                  sync=[m.sync_stats for m in state.model.modules() if hasattr(m, "sync_stats")])
    torch.save(record, out_path)
    dist.destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
