"""The serving mesh on the card: two replicas on ``cuda:0`` (a mesh may
repeat a device) against one engine, in the default and the opt-in
configurations; and, where the machine has two cards, two replicas on
``cuda:0`` and ``cuda:1``, and every kernel on ``cuda:1`` while device 0 is
current. Then int8 on a mesh: the exchange kernel (csrc/replica_max.cu)
against its plain version, a lone replica's trap, and the int8 mesh against
one int8 engine.

Imports nothing of JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_mesh_gpu.py -q -m gpu

The model is tests/test_torch_engine_gpu.py's: 2 dual-stream layers at
production width, 6 conformer blocks a forward, random weights from a seed.
"""
import numpy as np
import pytest
import torch

from chip_smoke import (
    check_replica_max, graph_kernel_nodes, hand_written, kernels_on_second_card,
    lone_replica_traps, read_counts, reset_counts,
)
from test_torch_engine_gpu import CONFIG, CONFIGS, DTYPES, PER_FORWARD, cuda, state, tone  # noqa: F401

from some_tpu_torch.inference.base_infer import SITES_PER_GRAPH, set_dispatch
from some_tpu_torch.inference.me_infer import MIDIExtractionInference
from some_tpu_torch.parallel.mesh import make_mesh, pad_rows, split_rows
from some_tpu_torch.utils.note_f1 import note_f1

pytestmark = pytest.mark.gpu


def engine(state, config, dtype, mesh=None):  # noqa: F811
    kwargs = {"mesh": mesh} if mesh is not None else {"device": "cuda"}
    return MIDIExtractionInference.from_state_dict(dict(CONFIG, **CONFIGS[config]), state,
                                                   dtype=DTYPES[dtype], **kwargs)


def hold_mesh_against_one_engine(state, config, dtype, devices):  # noqa: F811
    """Two replicas over ``devices`` against one engine on ``cuda:0``.
    Launches: an eager bucket run launches each replica's forward (twice
    the one engine's per forward). Graphs: prewarm captures the same shard
    buckets on each replica, each graph holding one forward's hand-written
    kernels (its kernel nodes). Outputs: gathered on ``cuda:0`` with device
    0 still current; graph replays equal the eager runs bit for bit; each
    shard equals the one engine's run of that shard bit for bit; in f32 the
    bucket is within 1e-4 of the one engine's run of the whole bucket (a
    shard changes cuBLAS's M)."""
    mesh = engine(state, config, dtype, make_mesh(devices))
    solo = engine(state, config, dtype)
    assert [r.device for r in mesh.replicas] == [torch.device(d) for d in devices]
    per_forward = PER_FORWARD[config]
    waves = [tone(s, f, i) for i, (s, f) in enumerate([(2.5, 330), (2.4, 440), (2.7, 392)])]
    groups, _ = solo.bucket_groups(waves)
    (_, audio, mask), = groups  # 3 rows of bucket 256: padded to 4, shards of 2
    assert audio.shape[0] == 3

    torch.cuda.set_device(0)
    set_dispatch(mesh, "eager")
    reset_counts()
    eager = mesh.run_bucket_staged(*mesh.stage_inputs(audio, mask), frames=True)
    launched = {k: v for k, v in read_counts().items() if v}
    assert launched == {k: 2 * v for k, v in per_forward.items()}
    assert [r.forwards for r in mesh.replicas] == [1, 1]

    set_dispatch(mesh, "graph")
    n = mesh.prewarm([mask.shape[1]], rows=(1, 2, 3, 4))
    assert n == 2 and [r.graphs_captured for r in mesh.replicas] == [2, 2]
    assert {k for r in mesh.replicas for k in r._graphs} == {("int16", 1, mask.shape[1]),
                                                            ("int16", 2, mask.shape[1])}
    graph = mesh.run_bucket_staged(*mesh.stage_inputs(audio, mask), frames=True)
    assert torch.cuda.current_device() == 0
    assert {v.device for v in (*graph.values(), *eager.values())} == {torch.device("cuda", 0)}
    for key in graph:
        assert torch.equal(graph[key], eager[key]), key
    shards = list(zip(*(split_rows(x, 2) for x in pad_rows(audio, mask, 2, mesh.wire,
                                                               mask.shape[1] * mesh.hop - 1))))
    for replica, (a, m) in zip(mesh.replicas, shards):
        assert hand_written(graph_kernel_nodes(torch, replica, a, m)) == per_forward
    for i, (a, m) in enumerate(shards):
        want = solo.run_bucket_staged(*solo.stage_inputs(a, m), frames=True)
        for key in want:
            assert torch.equal(graph[key][2 * i:2 * i + 2], want[key]), key
    if dtype == "f32":
        whole = solo.run_bucket_staged(*solo.stage_inputs(audio, mask), frames=True)
        for key in ("probs", "bounds"):
            torch.testing.assert_close(graph[key][:3], whole[key], rtol=0, atol=1e-4)
        assert torch.equal(graph["n_notes"][:3], whole["n_notes"])
    assert int(graph["n_notes"][3]) == 0


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("config", ["default", "opt_in"])
def test_two_replicas_on_one_card(cuda, state, config, dtype):  # noqa: F811
    """Two replicas on ``cuda:0`` (a mesh may repeat a device)."""
    hold_mesh_against_one_engine(state, config, dtype, ("cuda:0", "cuda:0"))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("config", ["default", "opt_in"])
def test_two_replicas_on_two_cards(cuda, state, config, dtype):  # noqa: F811
    """Replicas on ``cuda:0`` and ``cuda:1``, as ``--devices 2`` makes them
    (``make_serving_mesh``): the second replica launches with device 1
    current, and its outputs cross to ``cuda:0`` behind its replay."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from some_tpu_torch.infer import make_serving_mesh

    devices = ("cuda:0", "cuda:1")
    assert make_serving_mesh(2).devices == tuple(torch.device(d) for d in devices)
    hold_mesh_against_one_engine(state, config, dtype, devices)


def test_kernels_on_the_second_card(cuda):
    """K1-K4 and the backward kernels on ``cuda:1`` while device 0 is
    current, in f32 (chip_smoke's ``kernels_on_second_card``): bit for bit
    the same kernels' results on ``cuda:0``, and within their plain
    versions' tolerances; device 0 stays current, and both cards synchronise
    clean after it."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    ratios = kernels_on_second_card(torch)
    assert len(ratios) == 12 and max(ratios.values()) <= 1.0


@pytest.mark.parametrize("devices", [("cuda:0", "cuda:0"), ("cuda:0", "cuda:1")],
                         ids=["one_card", "two_cards"])
def test_replica_max_kernel_matches_plain(cuda, devices):
    """chip_smoke's ``check_replica_max``: 160 exchanges of two replicas on
    ``devices`` eagerly (a fresh card and a pinned allocation between the
    replicas' launches) and in captured graphs replayed 3 times, every
    output bit for bit the plain max; the bare traffic's replays, its
    bound, take no longer than the exchange's."""
    if "cuda:1" in devices and torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    row = check_replica_max(torch, devices=devices)
    assert row["max_abs_diff"] == 0.0 and 0 < row["bound_ms"] <= row["kernel_ms"]


def test_a_lone_replica_traps_in_its_bound(cuda):
    """One replica of a group of two exchanging alone, in a child process:
    its kernel traps after its 1 s bound, the synchronize raises, and the
    child ends; it never hangs."""
    got = lone_replica_traps(bound_s=1.0)
    assert got["raised_after_s"] >= 1.0 and got["child_wall_s"] < 120


def events(outs):
    """Note dicts of consecutive chunks -> (onsets, offsets, pitches) of the
    voiced notes, each chunk 10 s after the one before."""
    on, off, pitch = [], [], []
    for i, out in enumerate(outs):
        keep = ~out["note_rest"]
        start = 10.0 * i + np.concatenate([[0.0], np.cumsum(out["note_dur"])[:-1]])
        on.append(start[keep])
        off.append((start + out["note_dur"])[keep])
        pitch.append(out["note_midi"][keep])
    return tuple(np.concatenate(a) for a in (on, off, pitch))


@pytest.mark.parametrize("devices", [("cuda:0", "cuda:0"), ("cuda:0", "cuda:1")],
                         ids=["one_card", "two_cards"])
def test_int8_mesh(cuda, state, devices):  # noqa: F811
    """``quantize: int8`` over two replicas in bf16 against one int8 engine:
    at every int8 site of an eager bucket (8 a block, 2 a layer: 52 at 2
    layers; the bucket's first eager run warms each replica's stream up
    against a group of one) both replicas take the same max, bit for bit,
    and the second run equals the first; K1 and K2 launch
    once a block a replica, the exchange once a site a replica; the graphs
    (captured at once, their warm-ups against a group of one) replay the
    eager bucket bit for bit and hold 6 K1, 6 K2 and 52 exchanges a
    replica, in 4 segments of at most 16 sites; one replica's ``_run``
    alone is refused; note F1 >= 0.95
    against the one int8 engine (the int8 knife-edge bound)."""
    if "cuda:1" in devices and torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    config = dict(CONFIG, quantize="int8")
    mesh = MIDIExtractionInference.from_state_dict(config, state, dtype=torch.bfloat16,
                                                   mesh=make_mesh(devices))
    solo = MIDIExtractionInference.from_state_dict(config, state, dtype=torch.bfloat16,
                                                   device="cuda")
    sites = 8 * (2 * 2 + 2) + 2 * 2
    per_forward = dict(PER_FORWARD["default"], replica_max=sites)
    waves = [tone(s, f, i) for i, (s, f) in enumerate([(2.5, 330), (2.4, 440), (2.7, 392)])]
    groups, _ = solo.bucket_groups(waves)
    (_, audio, mask), = groups
    torch.cuda.set_device(0)

    set_dispatch(mesh, "eager")
    # a cold mesh: each replica's stream is first warmed up against a group of one
    first = mesh.run_bucket(audio, mask)
    seen = [[] for _ in mesh.replicas]
    for replica, record in zip(mesh.replicas, seen):
        def recording(amax, exchange=replica._member.max, record=record):
            record.append(exchange(amax))
            return record[-1]

        replica._member.max = recording
    reset_counts()
    eager = mesh.run_bucket(audio, mask)
    torch.cuda.synchronize()
    assert {k: v for k, v in read_counts().items() if v} == {
        k: 2 * v for k, v in per_forward.items()}
    for replica in mesh.replicas:
        del replica._member.max
    got = [torch.stack(record).cpu() for record in seen]
    assert len(got[0]) == sites and torch.equal(got[0], got[1])
    assert all(torch.equal(first[key], eager[key]) for key in eager)

    set_dispatch(mesh, "graph")
    graph = mesh.run_bucket(audio, mask)  # a bucket's first run captures on an int8 mesh
    assert [r.graphs_captured for r in mesh.replicas] == [1, 1]
    # a segment a SITES_PER_GRAPH sites, and the tail after the last site
    want_segments = sites // SITES_PER_GRAPH + 1
    assert [len(e.graphs) for r in mesh.replicas for e in r._graphs.values()] == [want_segments] * 2
    for key in graph:
        assert torch.equal(graph[key], eager[key]), key
    shards = list(zip(*(split_rows(x, 2) for x in pad_rows(audio, mask, 2, mesh.wire,
                                                               mask.shape[1] * mesh.hop - 1))))
    for replica, (a, m) in zip(mesh.replicas, shards):
        with replica.alone():
            assert hand_written(graph_kernel_nodes(torch, replica, a, m)) == per_forward
    a, m, _ = mesh.replicas[1]._stage(*shards[1])
    with pytest.raises(RuntimeError, match="alone"):
        mesh.replicas[1]._run(a, m, None, False, False)
    again = mesh.run_bucket(audio, mask)
    assert all(torch.equal(again[key], graph[key]) for key in graph)

    got, want = mesh.infer(waves), solo.infer(waves)
    f1 = note_f1(events(want), events(got), onset_tolerance=0.05, pitch_tolerance=0.5).f1
    assert len(events(want)[0]) > 0 and f1 >= 0.95
