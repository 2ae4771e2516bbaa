"""The port's inference engine against the JAX package's on the CPU: staged
dispatch and its depth, prewarm, every wire and the half-rate wire (with an
oversize split), wire_sr validation, the auto wire policy and its re-probe,
and the port's bench.

Both engines take the same weights (``MidiExtractor.init`` with randomized
BatchNorm statistics, carried across by ``compat/from_jax``) at the small
geometry of tests/test_torch_infer.py, in f32. On the CPU the port runs its
pipeline eagerly through the kernels' plain versions; the graphs it captures
on the card are held against that eager path by tests/test_torch_engine_gpu.py.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from some_tpu.inference.base_infer import BaseInference as JaxBase
from some_tpu.inference.me_infer import MIDIExtractionInference as JaxEngine
from some_tpu_torch.compat.from_jax import jax_params_to_state_dict
from some_tpu_torch.inference.base_infer import BaseInference, set_dispatch
from some_tpu_torch.inference.me_infer import MIDIExtractionInference
from tests.test_inference import synth
from tests.test_torch_infer import CONFIG, REPO

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "serial_rtf", "compute_only_rtf",
              "e2e_file_rtf", "e2e_file_stream_rtf", "file_host_fraction",
              "file_host_compute_fraction", "wire", "wire_sr"}


@pytest.fixture(scope="module")
def variables():
    from some_tpu.nn.model import build_midi_extractor as jax_build

    v = jax_build(CONFIG).init(jax.random.PRNGKey(0), np.zeros((1, 32, 80), np.float32))
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32), v["batch_stats"])
    return {"params": jax.tree_util.tree_map(np.asarray, v["params"]), "batch_stats": stats}


def engines(variables, **overrides):
    config = dict(CONFIG, **overrides)
    jax_engine = JaxEngine.from_variables(config, variables, dtype=jnp.float32)
    port = MIDIExtractionInference.from_state_dict(
        config, jax_params_to_state_dict(variables["params"], variables["batch_stats"]),
        dtype=torch.float32, device="cpu")
    return jax_engine, port


def assert_notes_match(got, want, midi_tol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(w["note_dur"]) > 0
        np.testing.assert_array_equal(g["note_rest"], w["note_rest"])
        np.testing.assert_allclose(g["note_dur"], w["note_dur"], rtol=0, atol=1e-12)
        np.testing.assert_allclose(g["note_midi"], w["note_midi"], rtol=midi_tol, atol=midi_tol)


WAVES = [(0.8, 330), (1.2, 440), (2.6, 392), (3.1, 523), (0.6, 494)]


def test_stream_depth_output_invariant(variables, monkeypatch):
    """Depths 0 (serial), 1 (double buffering) and 8 (stage all) give
    identical notes over several groups, and the JAX engine's."""
    jax_engine, port = engines(variables)
    port.max_batch_chunks = jax_engine.max_batch_chunks = 2
    waves = [synth(s, f, seed=i) for i, (s, f) in enumerate(WAVES)]
    ref = None
    for depth in ("0", "1", "8"):
        monkeypatch.setenv("SOME_TPU_STREAM_DEPTH", depth)
        out = port.infer(waves)
        if ref is None:
            ref = out
            assert_notes_match(out, jax_engine.infer(waves))
            continue
        for a, b in zip(ref, out):
            for key in ("note_midi", "note_rest", "note_dur"):
                np.testing.assert_array_equal(a[key], b[key])
    assert port.forwards == 3 * 4  # buckets 128 (3 chunks: 2 groups), 256, 384


@pytest.mark.parametrize("env", [{}, {"SOME_TPU_STREAM_DEPTH": "0"},
                                 {"SOME_TPU_STREAM_DEPTH": "8"},
                                 {"SOME_TPU_STREAM_DEPTH": "-3"},
                                 {"SOME_TPU_STREAM_DEPTH": "two"},
                                 {"SOME_TPU_STREAM_GROUPS": "0", "SOME_TPU_STREAM_DEPTH": "4"},
                                 {"SOME_TPU_STREAM_GROUPS": "1", "SOME_TPU_STREAM_DEPTH": "2"}])
def test_stream_depth_reads_the_environment_as_jax(monkeypatch, env):
    for name in ("SOME_TPU_STREAM_DEPTH", "SOME_TPU_STREAM_GROUPS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert BaseInference._stream_depth() == JaxBase._stream_depth()


@pytest.mark.parametrize("args", [([256], (1, 2), 1), ([256], (1, 2), 2),
                                  ([128, 384], (1, 2, 3, 4, 6, 8), 1),
                                  ([192], (5, 7, 8, 12), 1), ([128], (1, 3), 3)])
@pytest.mark.parametrize("max_batch_chunks", [8, 4])
def test_prewarm_counts_match_jax(variables, monkeypatch, args, max_batch_chunks):
    """The same programs for the same arguments. The JAX engine's runs are
    stubbed (only its count is compared); the port's run on the CPU."""
    jax_engine, port = engines(variables)
    jax_engine.max_batch_chunks = port.max_batch_chunks = max_batch_chunks
    shapes = []
    monkeypatch.setattr(jax_engine, "run_bucket", lambda audio, mask: shapes.append(
        mask.shape) or {"n_notes": np.zeros(len(mask), np.int32)})
    buckets, rows, workers = args
    n = port.prewarm(buckets, rows=rows, workers=workers)
    assert n == jax_engine.prewarm(buckets, rows=rows, workers=workers)
    assert port.forwards == n == len(shapes)
    with pytest.raises(ValueError, match="not a frame bucket"):
        port.prewarm([999])
    with pytest.raises(ValueError, match="not a frame bucket"):
        jax_engine.prewarm([999])


@pytest.mark.parametrize("wire", ["int16", "float32", "mulaw8", "mulaw12"])
def test_each_wire_matches_jax(variables, wire):
    jax_engine, port = engines(variables, transfer_dtype=wire)
    assert port.wire == jax_engine.wire == wire
    waves = [synth(2.6, 392, seed=3), synth(1.1, 523, seed=4)]
    assert_notes_match(port.infer(waves), jax_engine.infer(waves))


def test_half_rate_wire_matches_jax(variables):
    """wire_sr 22050: callers hand in native-rate audio; the second chunk's
    length is hop - 1 mod hop, where frames from the decimated length would
    gain one."""
    jax_engine, port = engines(variables, wire_sr=22050)
    assert (port.wire_factor, port.hop, port.wire_sr) == (2, 256, 22050)
    assert port.timestep == jax_engine.timestep
    wave2 = synth(2.0, 440, seed=6)
    wave2 = wave2[:len(wave2) - (len(wave2) % 512) - 1]
    waves = [synth(2.6, 330, seed=5), wave2]
    assert_notes_match(port.infer(waves), jax_engine.infer(waves))


def test_half_rate_wire_oversize_split_matches_jax(variables):
    """An oversize chunk on the half-rate wire: the split stride on the
    decimation grid, each piece a slice of the waveform decimated once."""
    jax_engine, port = engines(variables, wire_sr=22050)
    jax_engine.frame_buckets = port.frame_buckets = (64, 128)
    wave = synth(300 * 512 / 44100, 440, seed=21)
    got, want = port.infer([wave]), jax_engine.infer([wave])
    assert port.forwards == 2  # two parts in bucket 128 (one group), the rest in 64
    assert_notes_match(got, want)


@pytest.mark.parametrize("overrides,match", [({"wire_sr": 11025}, "fmax"),
                                             ({"wire_sr": 12000}, "divide"),
                                             ({"wire_sr": 8820, "fmax": 4000}, "divisible")])
def test_wire_sr_validation_raises_as_jax(variables, overrides, match):
    config = dict(CONFIG, **overrides)
    state = jax_params_to_state_dict(variables["params"], variables["batch_stats"])
    with pytest.raises(ValueError, match=match):
        MIDIExtractionInference.from_state_dict(config, state, device="cpu")
    with pytest.raises(ValueError, match=match):
        JaxEngine.from_variables(config, variables, dtype=jnp.float32)


@pytest.mark.parametrize("mb_s,overrides", [(1e9, {}), (1.0, {}), (1.0, {"fmax": 12000}),
                                            (1.0, {"wire_sr": 22050}), (199.0, {}),
                                            (200.0, {})])
def test_auto_wire_policy_matches_jax(mb_s, overrides):
    config = dict(CONFIG, **overrides)
    assert (MIDIExtractionInference._auto_wire_policy(mb_s, config)
            == JaxEngine._auto_wire_policy(mb_s, config))


def test_auto_wire_reprobe_flips_and_drops_graphs(variables, monkeypatch):
    """transfer_dtype auto: a fast probe gives the native int16 wire; within
    the TTL nothing re-probes; past it a slow link flips both engines to the
    half-rate wire, which drops the port's captured graphs (a stand-in entry
    here: the CPU captures none); recovery flips back."""
    link = {"mb_s": 1000.0}
    monkeypatch.setattr(BaseInference, "_probe_link_mb_s",
                        staticmethod(lambda device, probe_mb=8.0: link["mb_s"]))
    monkeypatch.setattr(JaxBase, "_probe_link_mb_s",
                        staticmethod(lambda probe_mb=8.0: link["mb_s"]))
    monkeypatch.setenv("SOME_TPU_WIRE_THRESHOLD_MB_S", "150")
    jax_engine, port = engines(variables, transfer_dtype="auto", wire_probe_ttl_s=1e9)
    assert (port.wire, port.wire_factor) == ("int16", 1)
    assert port._wire_threshold_mb_s == 150.0
    assert port.wire_decision == jax_engine.wire_decision
    wav = synth(0.7, 440, seed=13)
    assert_notes_match(port.infer([wav]), jax_engine.infer([wav]))

    link["mb_s"] = 40.0
    port._graphs[("int16", 1, 128)] = "captured"
    port.infer([wav])
    assert port.wire_factor == 1 and port.graphs_captured == 1  # the TTL holds

    port._wire_probe_time = jax_engine._wire_probe_time = -1e9
    slow, slow_jax = port.infer([wav]), jax_engine.infer([wav])
    assert (port.wire, port.wire_factor, port.wire_sr) == ("int16", 2, 22050)
    assert port.graphs_captured == 0
    assert port.mel.hop_length == 256
    assert port.wire_decision == jax_engine.wire_decision
    assert_notes_match(slow, slow_jax)

    link["mb_s"] = 1000.0
    port._wire_probe_time = jax_engine._wire_probe_time = -1e9
    again = port.infer([wav])
    assert port.wire_factor == 1
    assert_notes_match(again, jax_engine.infer([wav]))


def counting_bucket_groups(port):
    """Count ``port.bucket_groups``' calls (through the instance, as
    ``prepare`` and ``infer`` call it)."""
    calls = []
    inner = port.bucket_groups

    def bucket_groups(waveforms):
        calls.append(len(waveforms))
        return inner(waveforms)

    port.bucket_groups = bucket_groups
    return calls


def assert_same_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("case", ["oversize split", "frame buckets", "mesh of 2"])
def test_prepared_batch_infers_the_same_bits(variables, case):
    """``infer(w, prepared=prepare(w))`` gives ``infer(w)``'s replies bit for
    bit and buckets nothing itself: an oversize chunk split in three, a
    batch of three frame buckets in four groups, and a CPU mesh of two
    replicas."""
    state = jax_params_to_state_dict(variables["params"], variables["batch_stats"])
    if case == "mesh of 2":
        from some_tpu_torch.parallel.mesh import make_mesh

        port = MIDIExtractionInference.from_state_dict(CONFIG, state, dtype=torch.float32,
                                                       mesh=make_mesh(["cpu"] * 2))
        waves = [synth(s, f, seed=i) for i, (s, f) in enumerate(WAVES[:3])]
    else:
        port = MIDIExtractionInference.from_state_dict(CONFIG, state, dtype=torch.float32,
                                                       device="cpu")
        if case == "oversize split":
            port.frame_buckets = (64, 128)
            waves = [synth(300 * 512 / 44100, 440, seed=21)]
        else:
            port.max_batch_chunks = 2
            waves = [synth(s, f, seed=i) for i, (s, f) in enumerate(WAVES)]
    calls = counting_bucket_groups(port)
    want = port.infer(waves)
    prepared = port.prepare(waves)
    assert prepared.generation == port._wire_generation and len(calls) == 2
    if case == "oversize split":
        assert prepared.n_parts == [3]
    if case == "frame buckets":
        assert len(prepared.groups) == 4
    assert_same_bits(port.infer(waves, prepared=prepared), want)
    assert len(calls) == 2  # the prepared groups were used


def test_a_wire_flip_makes_a_prepared_batch_stale(variables):
    """A wire change between ``prepare`` and ``infer`` (``_set_wire``
    advances the generation, as the auto wire's re-probe does) makes
    ``infer`` bucket again, and its replies are a fresh ``infer``'s under
    the new wire; a change while ``prepare`` buckets leaves the batch
    stale at once."""
    _, port = engines(variables)
    waves = [synth(0.9, 392, seed=31), synth(2.2, 494, seed=32)]
    calls = counting_bucket_groups(port)
    prepared = port.prepare(waves)
    assert port.wire == "int16" and prepared.groups[0][1].dtype == np.int16
    generation = port._wire_generation
    port._set_wire("float32")
    port._rebuild_wire_pipeline()
    assert port._wire_generation == generation + 1
    got = port.infer(waves, prepared=prepared)
    assert len(calls) == 2
    assert_same_bits(got, port.infer(waves))

    inner = port.bucket_groups

    def flipping(waveforms):
        out = inner(waveforms)
        port._set_wire(port.wire)
        return out

    port.bucket_groups = flipping
    stale = port.prepare(waves)
    assert stale.generation is None
    port.bucket_groups = inner
    assert_same_bits(port.infer(waves, prepared=stale), got)
    assert len(calls) == 5  # the stale batch was bucketed again


def test_frame_outputs_and_dispatch_switch(variables):
    _, port = engines(variables)
    groups, n_parts = port.bucket_groups([synth(1.0, 440, seed=1)])
    assert n_parts == [1] and len(groups) == 1
    _, audio, mask = groups[0]
    out = port.run_bucket_staged(*port.stage_inputs(audio, mask), frames=True)
    assert set(out) == set(port.OUTPUT_KEYS) | {"probs", "bounds"}
    assert out["probs"].shape == (1, 128, 128) and out["bounds"].shape == (1, 128)
    assert set(port.run_bucket(audio, mask)) == set(port.OUTPUT_KEYS)
    set_dispatch(port, "eager")
    with pytest.raises(ValueError, match="graph | eager"):
        set_dispatch(port, "compiled")


def test_bench_on_the_cpu_prints_bench_keys():
    env = dict(os.environ, SOME_BENCH_LAY="1", SOME_BENCH_DIM="32", SOME_BENCH_B="2",
               SOME_BENCH_T="128", SOME_BENCH_ITERS="1", SOME_BENCH_PHRASES="1")
    out = subprocess.run([sys.executable, "-m", "some_tpu_torch.bench", "--device", "cpu"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert BENCH_KEYS | {"device", "wire_decision", "e2e_file_cold_rtf",
                         "cold_load_s"} <= set(result)
    assert result["device"] == "cpu" and result["metric"] == "inference_rtf_x_realtime"
    assert result["wire"] == "int16" and result["wire_decision"]["wire"] == "int16"
    assert all(result[k] > 0 for k in ("value", "serial_rtf", "compute_only_rtf",
                                       "e2e_file_rtf", "e2e_file_stream_rtf",
                                       "e2e_file_cold_rtf", "cold_load_s"))


def test_bench_needs_a_card_unless_told(monkeypatch):
    from some_tpu_torch import bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


@pytest.mark.parametrize("name, value", [("SOME_BENCH_MEL", "dft"), ("SOME_BENCH_QUANT", "int8")])
def test_bench_stops_on_a_path_the_port_lacks(monkeypatch, name, value):
    """The knobs keep bench.py's names and take its values: the bench runs
    with the dft mel and with int8 at a tiny geometry on the CPU (its line
    says which, and int8 holds fewer weight bytes than the f32 default); a
    value the port has no path for still stops it with a message before any
    model is built."""
    from some_tpu_torch import bench

    monkeypatch.setenv(name, "bogus")
    with pytest.raises(SystemExit, match=f"{name}=bogus: not one of"):
        bench.build_engine("cpu")
    env = dict(os.environ, SOME_BENCH_LAY="1", SOME_BENCH_DIM="32", SOME_BENCH_B="2",
               SOME_BENCH_T="128", SOME_BENCH_ITERS="1", SOME_BENCH_PHRASES="1",
               SOME_BENCH_FILE="0", **{name: value})
    out = subprocess.run([sys.executable, "-m", "some_tpu_torch.bench", "--device", "cpu"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["device"] == "cpu" and result["value"] > 0 and result["compute_only_rtf"] > 0
    key = "mel_method" if name == "SOME_BENCH_MEL" else "quantize"
    assert result[key] == value
    monkeypatch.delenv(name)
    monkeypatch.setenv("SOME_BENCH_LAY", "1")
    monkeypatch.setenv("SOME_BENCH_DIM", "32")
    engine, _, _ = bench.build_engine("cpu", batch_chunks=2)
    assert engine.config["mel_method"] == "rfft" and engine.config["quantize"] == "none"
    if name == "SOME_BENCH_QUANT":
        assert result["weight_bytes"] < engine.weight_bytes
