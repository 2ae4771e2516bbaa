"""The port's compiled train and valid steps on the card: one CUDA graph per
batch bucket (and accumulation position) against the eager dispatch of the
same task (``base_task.set_train_dispatch``), bit for bit.

Imports nothing of JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_train_graph_gpu.py -q -m gpu

Every test is marked ``gpu`` and skips without a card (the two-process test
also without a second card). The model is configs/midi_conformer.yaml cut to
2 dual-stream layers at production width (dim 512, 8 x 64 heads, k = 31,
bf16, remat on, dropout 0.1), so a train step runs 6 conformer blocks, 4 of
them remat'd; weights are seeded.
"""
import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

from chip_smoke import OPT_IN, production_config, synthetic_items

from some_tpu_torch.training.base_task import set_train_dispatch
from some_tpu_torch.training.me_task import MIDIExtractionTask
from some_tpu_torch.utils.profiling import hand_written_nodes

pytestmark = pytest.mark.gpu

REPO = pathlib.Path(__file__).resolve().parent.parent
LAYERS = 2
BLOCKS, REMAT_BLOCKS = 2 * LAYERS + 2, 2 * LAYERS


def _config(**overrides):
    config = production_config(**overrides)
    config["midi_extractor_args"] = dict(config["midi_extractor_args"], lay=LAYERS)
    return config


def _per_step(attn):
    return {"depthwise_conv1d": BLOCKS + REMAT_BLOCKS, "depthwise_conv1d_dx": BLOCKS,
            "depthwise_conv1d_dw": BLOCKS, f"{attn}_fwd_res": BLOCKS + REMAT_BLOCKS,
            f"{attn}_bwd_dkv": BLOCKS, f"{attn}_bwd_dq": BLOCKS}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pair(config):
    """A task on the graph dispatch and one on the eager dispatch, from one
    seeded start."""
    graph, eager = MIDIExtractionTask(config), MIDIExtractionTask(config)
    set_train_dispatch(eager, "eager")
    state_g, state_e = graph.init_state(seed=5), eager.init_state(seed=5)
    return graph, state_g, eager, state_e


def _assert_states_equal(state_g, state_e):
    got, want = state_g.static_tensors(), state_e.static_tensors()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _train_pair(config, item_batches):
    graph, state_g, eager, state_e = _pair(config)
    kinds = []
    for items in item_batches:
        batch = graph.collate(items)
        logs_g = graph.train_step(state_g, batch)
        logs_e = eager.train_step(state_e, batch)
        kinds.append(graph.last_dispatch)
        assert eager.last_dispatch == "eager"
        for key in logs_e:
            assert torch.equal(logs_g[key], logs_e[key]), key
    torch.cuda.synchronize()
    _assert_states_equal(state_g, state_e)
    return graph, state_g, eager, state_e, kinds


@pytest.mark.parametrize("name", ["default", "opt_in"])
def test_graph_steps_equal_eager(cuda, name):
    """Two buckets in turns, 6 steps: eager, eager, capture, capture, replay,
    replay; losses, grad_norm, every parameter, BatchNorm statistic, AdamW
    moment and step count and the lr bit for bit with the eager dispatch;
    each step graph holds the hand-written kernels of one step as nodes;
    then the valid step, graph against eager, and its graphs' nodes."""
    config = _config(**(OPT_IN if name == "opt_in" else {}))
    a = synthetic_items(1, 4, 80, lo=400, hi=500)
    b = synthetic_items(2, 4, 80, lo=700, hi=760)
    graph, state_g, eager, state_e, kinds = _train_pair(config, [a, b] * 3)
    assert kinds == ["eager", "eager", "capture", "capture", "replay", "replay"]
    attn = "splash_attention" if name == "opt_in" else "flash_attention"
    assert len(state_g.graphs) == 2
    for entry in state_g.graphs.values():
        assert hand_written_nodes(entry.graph, training=True) == _per_step(attn)
    valid = [synthetic_items(3, 1, 80, lo=500, hi=600),
             synthetic_items(4, 1, 80, lo=900, hi=1000)]
    per_valid = ({"depthwise_conv1d": BLOCKS, "fused_ln_ffn_residual": 2 * BLOCKS,
                  "splash_attention": BLOCKS} if name == "opt_in" else
                 {"depthwise_conv1d": BLOCKS, "flash_attention": BLOCKS})
    kinds = []
    for items in valid * 3:
        batch = graph.collate(items)
        (losses_g, extras_g) = graph.valid_step(state_g, batch)
        (losses_e, extras_e) = eager.valid_step(state_e, batch)
        kinds.append(graph.last_dispatch)
        for key in losses_e:
            assert torch.equal(losses_g[key], losses_e[key]), key
        for key in extras_e:
            if key == "note_midi":  # the decode's float index_add_ is atomic
                assert float((extras_g[key] - extras_e[key]).abs().max()) <= 1e-3
            else:
                assert torch.equal(extras_g[key], extras_e[key]), key
    assert kinds == ["eager", "eager", "capture", "capture", "replay", "replay"]
    valid_graphs = [e for k, e in state_g.graphs.items() if k[0][0] == "valid"]
    assert len(valid_graphs) == 2
    for entry in valid_graphs:
        assert hand_written_nodes(entry.graph, training=False) == per_valid
    assert state_g.model.training


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch", "save_attn_conv"])
def test_graph_steps_equal_eager_under_remat_policy(cuda, policy):
    items = synthetic_items(5, 4, 80, lo=400, hi=500)
    graph, state_g, _, _, kinds = _train_pair(_config(remat_policy=policy), [items] * 3)
    assert kinds == ["eager", "capture", "replay"]
    (entry,) = state_g.graphs.values()
    assert hand_written_nodes(entry.graph, training=True) == _per_step("flash_attention")


def test_graph_accumulation_with_frozen_projection(cuda):
    """accumulate_grad_batches 2, in_proj_midi frozen, two buckets in turns
    (each accumulation group spans both): the accumulator and the moments
    carried across their graphs, bit for bit with eager; the frozen weights
    do not move."""
    config = _config(accumulate_grad_batches=2, freezing_enabled=True,
                     frozen_params=["model.backbone.in_proj_midi"])
    a = synthetic_items(6, 4, 80, lo=400, hi=500)
    b = synthetic_items(7, 4, 80, lo=700, hi=760)
    graph, state_g, _, _, kinds = _train_pair(config, [a, b] * 3)
    start = MIDIExtractionTask(config).init_state(seed=5).model.backbone.in_proj_midi.weight
    assert torch.equal(state_g.model.backbone.in_proj_midi.weight, start)
    assert kinds == ["eager", "eager", "capture", "capture", "replay", "replay"]
    assert sorted(k[0] for k in state_g.graphs) == [("train", 0), ("train", 1)]
    assert state_g.accumulator is None and state_g.step == 6


WORKER = """
import os, sys, torch
sys.path.insert(0, sys.argv[1])
from chip_smoke import production_config, synthetic_items
from some_tpu_torch.parallel import distributed as dist
from some_tpu_torch.training.base_task import set_train_dispatch
from some_tpu_torch.training.me_task import MIDIExtractionTask
dist.maybe_initialize("cuda")
config = production_config()
config["midi_extractor_args"] = dict(config["midi_extractor_args"], lay=int(sys.argv[4]))
task = MIDIExtractionTask(config)
if sys.argv[3] == "eager":
    set_train_dispatch(task, "eager")
state = task.init_state(seed=5)
rank, world = dist.rank(), dist.world_size()
batches = [synthetic_items(8, 8, 80, lo=400, hi=500), synthetic_items(9, 8, 80, lo=700, hi=760)]
logs, kinds = [], []
for items in batches * 3:
    rows = items[4 * rank: 4 * rank + 4]
    common = {"t": max(i["length"] for i in items), "b": 4,
              "n": max(len(i["note_midi"]) for i in items)}
    out = task.train_step(state, task.collate(rows, common=common))
    logs.append({k: v.cpu() for k, v in out.items()})
    kinds.append(task.last_dispatch)
torch.save({"logs": logs, "kinds": kinds, "state": {k: v.cpu() for k, v in
            state.model.state_dict().items()}}, sys.argv[2])
task.release_graphs(state)  # NCCL's teardown waits for graphs of its collectives
dist.destroy()
"""


def test_two_processes_over_nccl(cuda, tmp_path):
    """Two processes, one card each, over NCCL: the gradients', losses' and
    BatchNorm sums inside the captured steps. Both ranks hold the same
    weights, and the graph dispatch equals the eager one bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    runs = {}
    for dispatch in ("graph", "eager"):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        procs = []
        for rank in range(2):
            env = dict(os.environ, SOME_TPU_COORDINATOR=f"127.0.0.1:{port}",
                       SOME_TPU_NUM_PROCESSES="2", SOME_TPU_PROCESS_ID=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", WORKER, str(REPO), str(tmp_path / f"{dispatch}{rank}.pt"),
                 dispatch, str(LAYERS)], env=env))
        assert [p.wait(timeout=300) for p in procs] == [0, 0]
        runs[dispatch] = [torch.load(tmp_path / f"{dispatch}{r}.pt") for r in range(2)]
    graph, eager = runs["graph"], runs["eager"]
    assert graph[0]["kinds"] == ["eager", "eager", "capture", "capture", "replay", "replay"]
    for rank in range(2):
        for key, value in eager[rank]["state"].items():
            assert torch.equal(graph[rank]["state"][key], value), key
            assert torch.equal(graph[0]["state"][key], graph[1]["state"][key]), key
        for got, want in zip(graph[rank]["logs"], eager[rank]["logs"]):
            assert all(torch.equal(got[k], want[k]) for k in want)
