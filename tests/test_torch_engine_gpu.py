"""The port's inference engine on the card: one CUDA graph per (wire, rows,
frames) bucket against the eager dispatch of the same engine.

Imports nothing of JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_engine_gpu.py -q -m gpu

Every test is marked ``gpu`` and skips without a card. The model is cut to 2
dual-stream layers at production width (dim 512, 8 x 64 heads, k = 31), so a
forward runs 6 conformer blocks; weights are random from a seed (numpy, the
JAX layout, carried across).
"""
import numpy as np
import pytest
import torch

from chip_smoke import OPT_IN, graph_kernel_nodes, hand_written, kernel_names, profiled_replay

from some_tpu_torch.compat.from_jax import jax_params_to_state_dict, random_jax_variables
from some_tpu_torch.inference.base_infer import BaseInference, set_dispatch
from some_tpu_torch.inference.me_infer import MIDIExtractionInference
from some_tpu_torch.nn.model import build_midi_extractor

pytestmark = pytest.mark.gpu

SR, HOP = 44100, 512
LAYERS = 2
BLOCKS = 2 * LAYERS + 2
CONFIG = {
    "audio_sample_rate": SR, "hop_size": HOP, "win_size": 2048, "fmin": 40, "fmax": 8000,
    "units_dim": 80, "midi_num_bins": 128, "midi_min": 0, "midi_max": 127,
    "midi_prob_deviation": 1.0, "rest_threshold": 0.1, "units_encoder": "mel",
    "task_cls": "training.MIDIExtractionTask", "transfer_dtype": "int16",
    "midi_extractor_args": {
        "lay": LAYERS, "dim": 512, "use_lay_skip": True, "kernel_size": 31, "conv_drop": 0.1,
        "ffn_latent_drop": 0.1, "ffn_out_drop": 0.1, "attention_drop": 0.1,
        "attention_heads": 8, "attention_heads_dim": 64},
}
CONFIGS = {"default": {}, "opt_in": OPT_IN}
PER_FORWARD = {"default": {"depthwise_conv1d": BLOCKS, "flash_attention": BLOCKS},
               "opt_in": {"depthwise_conv1d": BLOCKS, "fused_ln_ffn_residual": 2 * BLOCKS,
                          "splash_attention": BLOCKS}}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def state():
    variables = random_jax_variables(build_midi_extractor(CONFIG), seed=2718)
    return jax_params_to_state_dict(variables["params"], variables["batch_stats"])


def make_engine(state, config="default", dtype="f32", **overrides):
    return MIDIExtractionInference.from_state_dict(
        dict(CONFIG, **CONFIGS[config], **overrides), state, dtype=DTYPES[dtype], device="cuda")


def tone(seconds, freq, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    f = freq * 2 ** (np.floor(t * 3) % 5 / 12)  # a step every third of a second
    return (0.4 * np.sin(2 * np.pi * f * t)
            + 0.005 * rng.standard_normal(len(t))).astype(np.float32)


def assert_notes_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(w["note_dur"]) > 0
        np.testing.assert_array_equal(g["note_dur"], w["note_dur"])
        np.testing.assert_array_equal(g["note_rest"], w["note_rest"])
        # the decode's float index_add_ is atomic on CUDA: f32 rounding
        np.testing.assert_allclose(g["note_midi"], w["note_midi"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("config", ["default", "opt_in"])
def test_graph_replay_matches_eager_bit_for_bit(cuda, state, config, dtype):
    graph = make_engine(state, config, dtype)
    eager = make_engine(state, config, dtype)
    set_dispatch(eager, "eager")
    waves = [tone(s, f, i) for i, (s, f) in enumerate([(3.1, 330), (2.2, 440), (5.6, 392)])]
    groups, _ = graph.bucket_groups(waves)
    for _, audio, mask in groups:
        for _ in range(3):  # eager, then capture and replay, then a replay
            got = graph.run_bucket_staged(*graph.stage_inputs(audio, mask), frames=True)
            want = eager.run_bucket_staged(*eager.stage_inputs(audio, mask), frames=True)
            for key in ("probs", "bounds", "n_notes", "note_dur", "note_rest"):
                assert torch.equal(got[key], want[key]), key
            torch.testing.assert_close(got["note_midi"], want["note_midi"], rtol=0, atol=1e-4)
    assert graph.graphs_captured == len(groups)
    assert graph.forwards == eager.forwards == 3 * len(groups)


def test_first_run_is_eager_second_captures(cuda, state):
    """A bucket's first run is eager (no capture: a file through the CLI
    sees most buckets once), its second captures the graph, later ones
    replay it; another bucket starts its own count."""
    engine = make_engine(state)
    assert engine.CAPTURE_ON_VISIT == 2
    audio, mask = engine.bucket_groups([tone(1.0, 440, 1)])[0][0][1:]
    engine.run_bucket(audio, mask)
    assert engine.graphs_captured == 0 and engine.forwards == 1
    engine.run_bucket(audio, mask)
    assert engine.graphs_captured == 1 and engine.forwards == 2
    engine.run_bucket(audio, mask)
    assert engine.graphs_captured == 1 and engine.forwards == 3
    engine.run_bucket(*engine.bucket_groups([tone(3.0, 440, 1)])[0][0][1:])
    assert engine.graphs_captured == 1 and engine.forwards == 4


def test_shared_pool_graphs_replay_in_any_order(cuda, state):
    """The graphs share one memory pool. Replayed in shuffled orders, with
    each run's outputs kept while the others replay, every bucket still
    gives the eager dispatch's probs and bounds bit for bit."""
    graph = make_engine(state)
    eager = make_engine(state)
    set_dispatch(eager, "eager")
    assert graph.prewarm([128, 192, 256], rows=(1, 2)) == 6
    assert len({entry.graph.pool() for entry in graph._graphs.values()}) == 1
    rng = np.random.default_rng(5)
    inputs = []
    for frames in (128, 192, 256):
        for rows in (1, 2):
            waves = [tone(frames * HOP / SR * 0.9, 220 + 60 * i, i) for i in range(rows)]
            _, audio, mask = graph.bucket_groups(waves)[0][0]
            inputs.append((audio, mask, eager.run_bucket_staged(
                *eager.stage_inputs(audio, mask), frames=True)))
    for _ in range(3):
        order = rng.permutation(len(inputs))
        outs = [graph.run_bucket_staged(*graph.stage_inputs(*inputs[i][:2]), frames=True)
                for i in order]
        for i, got in zip(order, outs):
            for key in ("probs", "bounds", "n_notes", "note_dur", "note_rest"):
                assert torch.equal(got[key], inputs[i][2][key]), (key, inputs[i][1].shape)
    assert graph.graphs_captured == 6


def test_two_groups_of_one_bucket_match_eager(cuda, state):
    """16 chunks of one bucket run as two groups of 8 rows through one graph:
    infer dispatches both before it fetches either, so each run must hand
    back its own outputs before the next replay overwrites the graph's."""
    waves = [tone(1.6 + 0.01 * i, 220 + 20 * i, i) for i in range(16)]  # all in bucket 192
    graph = make_engine(state)
    eager = make_engine(state)
    set_dispatch(eager, "eager")
    graph.infer(waves)  # the first group runs eagerly, the second captures
    got = graph.infer(waves)  # two replays of one graph
    want = eager.infer(waves)
    assert graph.graphs_captured == 1 and graph.forwards == 4
    assert_notes_equal(got, want)
    assert any(not np.array_equal(got[i]["note_midi"], got[i + 8]["note_midi"])
               for i in range(8))


@pytest.mark.parametrize("depth", ["0", "1", "8"])
def test_staged_dispatch_matches_serial(cuda, state, monkeypatch, depth):
    waves = [tone(s, f, i) for i, (s, f) in enumerate(
        [(0.8, 330), (1.2, 440), (2.6, 392), (3.1, 523), (0.6, 494), (7.0, 262)])]
    engine = make_engine(state)
    engine.max_batch_chunks = 2
    monkeypatch.setenv("SOME_TPU_STREAM_DEPTH", "0")
    want = engine.infer(waves)
    monkeypatch.setenv("SOME_TPU_STREAM_DEPTH", depth)
    assert_notes_equal(engine.infer(waves), want)


def test_prewarm_then_traffic(cuda, state):
    engine = make_engine(state)
    assert engine.prewarm([192], rows=(1, 2)) == 2
    assert engine.graphs_captured == 2 and engine.forwards == 2
    assert engine.prewarm([192], rows=(1, 2), workers=2) == 2
    assert engine.graphs_captured == 2
    with pytest.raises(ValueError):
        engine.prewarm([999])
    waves = [tone(2.0, 440, 4), tone(2.2, 330, 5)]
    out = engine.infer(waves)
    assert engine.graphs_captured == 2  # bucket 192, two rows: captured by prewarm
    eager = make_engine(state)
    set_dispatch(eager, "eager")
    assert_notes_equal(out, eager.infer(waves))


def test_prewarm_from_threads_captures_each_graph_once(cuda, state):
    engine = make_engine(state)
    assert engine.prewarm([128, 192, 256], rows=(1, 2, 3), workers=4) == 9
    assert engine.graphs_captured == 9


def test_wire_flip_recaptures(cuda, state, monkeypatch):
    link = {"mb_s": 1000.0}
    monkeypatch.setattr(BaseInference, "_probe_link_mb_s",
                        staticmethod(lambda device, probe_mb=8.0: link["mb_s"]))
    engine = make_engine(state, transfer_dtype="auto", wire_probe_ttl_s=1e9)
    wav = tone(2.0, 440, 13)  # 173 frames: bucket 192
    engine.infer([wav])
    fast = engine.infer([wav])[0]
    assert set(engine._graphs) == {("int16", 1, 192)}
    assert engine._graphs[("int16", 1, 192)].audio.shape[1] == 192 * 512 - 1
    link["mb_s"] = 40.0
    engine._wire_probe_time = -1e9
    engine.infer([wav])
    slow = engine.infer([wav])[0]
    assert (engine.wire, engine.wire_factor) == ("int16", 2)
    assert engine.graphs_captured == 1  # the native-rate graph went with the flip
    assert engine._graphs[("int16", 1, 192)].audio.shape[1] == 192 * 256 - 1
    np.testing.assert_array_equal(slow["note_rest"], fast["note_rest"])
    np.testing.assert_allclose(slow["note_midi"], fast["note_midi"], atol=0.05)


@pytest.mark.parametrize("config", ["default", "opt_in"])
def test_profiled_replay_runs_the_kernels(cuda, state, config):
    """The graph holds one hand-written kernel node for each module that has
    a kernel, and a profiled replay runs them, as an eager forward does."""
    graph = make_engine(state, config, "bf16")
    eager = make_engine(state, config, "bf16")
    set_dispatch(eager, "eager")
    audio, mask = graph.bucket_groups([tone(4.0, 392, 7)])[0][0][1:]
    graph.run_bucket(audio, mask)
    graph.run_bucket(audio, mask)  # the second run captures
    assert hand_written(graph_kernel_nodes(torch, graph, audio, mask)) == PER_FORWARD[config]
    assert graph.graphs_captured == 1
    replay, _ = profiled_replay(torch, graph, graph.stage_inputs(audio, mask), PER_FORWARD[config])
    assert hand_written(replay) == PER_FORWARD[config]
    staged_eager = eager.stage_inputs(audio, mask)
    forward = kernel_names(torch, lambda: eager.run_bucket_staged(*staged_eager))
    assert hand_written(forward) == PER_FORWARD[config]


def test_failed_capture_raises(cuda, state, monkeypatch):
    """A capture that fails raises and caches nothing; the engine does not
    run the bucket eagerly instead (its first run was eager, as always)."""
    engine = make_engine(state)
    pipeline = engine._device_pipeline

    def syncs(audio, mask):
        out = pipeline(audio, mask)
        out["n_notes"].cpu()  # waits for the card: refused inside a capture
        return out

    monkeypatch.setattr(engine, "_device_pipeline", syncs)
    audio, mask = engine.bucket_groups([tone(1.0, 440, 1)])[0][0][1:]
    engine.run_bucket(audio, mask)
    with pytest.raises(RuntimeError):
        engine.run_bucket(audio, mask)
    assert engine.graphs_captured == 0 and engine.forwards == 1
