"""Headline benchmark of the port: real-time factor of waveform -> notes.

Counterpart of the JAX package's ``bench.py``. Audio seconds transcribed per
wall-clock second on one card, through the production continuous model
(``configs/midi_conformer.yaml``: 8 dual-stream conformer layers, dim 512,
bf16), random weights from a seed, and the engine's whole device pipeline
(wire decode, log-mel, conformer, note decode) as one CUDA graph per bucket.

    python -m some_tpu_torch.bench [--device cuda]

Prints one JSON line on stdout with ``bench.py``'s keys: ``value`` is the RTF
with the production dispatch (a staging thread copies batch N+1 while batch
N computes, lookahead ``SOME_TPU_STREAM_DEPTH``, default 1), ``serial_rtf``
stage-then-run, ``compute_only_rtf`` device-resident inputs through the
graph, ``e2e_file_rtf`` WAV file -> MIDI file, ``e2e_file_stream_rtf`` four
songs with the next song's decode and slicing on a worker thread (both
once every bucket's graph is captured), ``file_host_fraction`` the share
of file-to-file time the card is not computing and
``file_host_compute_fraction`` the part of it that is host code;
``e2e_file_cold_rtf`` is the infer CLI's own case, a fresh process's
``load_engine`` + ``transcribe_file`` of the song (a bucket's first run
eager, its second captured), and ``cold_load_s`` its ``load_engine``.
``device`` names the card (``nvidia-smi``). ``vs_baseline`` is against
the reference README's 300x real time on an RTX 3080 Ti. Diagnostics go to
stderr.

Knobs, as environment variables under ``bench.py``'s names: SOME_BENCH_B
(chunks a batch, 32), SOME_BENCH_T (frames a chunk, 1024), SOME_BENCH_ITERS
(batches a round, 5; best of 3 rounds), SOME_BENCH_PHRASES (phrases of the
file song, 32), SOME_BENCH_FILE (0 skips the file phases), SOME_BENCH_LAY /
SOME_BENCH_DIM (model depth and width), SOME_BENCH_WIRE (transfer_dtype,
``auto``), SOME_BENCH_WIRE_SR (half-rate wire, 0 = native), SOME_BENCH_MEL
(mel method: ``rfft`` or ``dft``) and SOME_BENCH_QUANT (quantization:
``none`` or ``int8``); any other value of those two stops the bench with a
message. Without a card it raises; ``--device cpu`` runs the plain
versions, for a test at a tiny geometry, and its line says ``"device":
"cpu"``.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from some_tpu_torch.audio.slicer import SilenceSlicer
from some_tpu_torch.audio.wavio import decimate_wire, load_wav, save_wav
from some_tpu_torch.audio.wire import encode_wire
from some_tpu_torch.compat.from_jax import jax_params_to_state_dict, random_jax_variables
from some_tpu_torch.config import read_full_config, save_yaml
from some_tpu_torch.inference.base_infer import resolve_device
from some_tpu_torch.inference.me_infer import MIDIExtractionInference
from some_tpu_torch.inference.pipeline import MAX_SIL_KEPT_MS
from some_tpu_torch.nn.model import build_midi_extractor
from some_tpu_torch.utils.checkpoint import save_checkpoint
from some_tpu_torch.utils.midi_file import build_midi_file

BASELINE_RTF = 300.0  # the reference README's figure, RTX 3080 Ti (bench.py:27)
REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIG = REPO / "configs" / "midi_conformer.yaml"
#: the knobs that choose a path: (name, config key, its values, the first the default)
PATH_KNOBS = (("SOME_BENCH_MEL", "mel_method", ("rfft", "dft")),
              ("SOME_BENCH_QUANT", "quantize", ("none", "int8")))
# a fresh process's load_engine + transcribe_file, timed inside it: argv is
# the checkpoint, the WAV, the MIDI path, the device ('' = the default) and
# Python run on `engine` after the load (untimed; '' = nothing)
COLD_CHILD = """
import json, sys, time, torch
from some_tpu_torch.infer import load_engine, transcribe_file
model, wav, midi, device, prelude = sys.argv[1:6]
t0 = time.perf_counter()
engine = load_engine(model, device=device or None, quiet=True)
sync = torch.cuda.synchronize if engine.device.type == "cuda" else lambda: None
sync()
load_s = time.perf_counter() - t0
exec(prelude)
t0 = time.perf_counter()
transcribe_file(engine, wav, midi)
sync()
print(json.dumps({"load_s": load_s, "file_s": time.perf_counter() - t0,
                  "forwards": engine.forwards, "graphs": engine.graphs_captured}))
"""


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name) or default)


def build_engine(device, batch_chunks: int = 32, seed: int = 0):
    """The production config with the SOME_BENCH_* overrides, random weights
    from ``seed`` (numpy, JAX layout, carried across), bf16."""
    config = read_full_config(CONFIG)
    args = config["midi_extractor_args"]
    args["lay"] = _env_int("SOME_BENCH_LAY", args["lay"])
    args["dim"] = _env_int("SOME_BENCH_DIM", args["dim"])
    if args["dim"] < 128:
        args["attention_heads"] = 2
    for name, key, values in PATH_KNOBS:
        value = os.environ.get(name) or values[0]
        if value not in values:
            raise SystemExit(f"{name}={value}: not one of {', '.join(values)}")
        config[key] = value
    config["transfer_dtype"] = os.environ.get("SOME_BENCH_WIRE", "auto")
    config["wire_sr"] = _env_int("SOME_BENCH_WIRE_SR", 0) or None
    # the f32 weights; an int8 engine quantizes them as it loads them
    variables = random_jax_variables(build_midi_extractor(config, quantize="none"), seed=seed)
    state = jax_params_to_state_dict(variables["params"], variables["batch_stats"])
    engine = MIDIExtractionInference.from_state_dict(
        config, state, dtype=torch.bfloat16, max_batch_chunks=batch_chunks, device=device)
    return engine, config, state


def make_song_wav(path, sr: int, n_phrases: int = 32, phrase_s: float = 10.5,
                  gap_s: float = 0.7) -> float:
    """bench.py's song: sine phrases with a second harmonic and noise, parted
    by silence, so the slicer emits production-shaped (~11 s) chunks.
    Returns its length in seconds."""
    rng = np.random.default_rng(42)
    parts = []
    for _ in range(n_phrases):
        t = np.arange(int(sr * phrase_s)) / sr
        f = 220.0 * 2 ** (rng.integers(0, 25) / 12)
        sig = (0.4 * np.sin(2 * np.pi * f * t) + 0.1 * np.sin(2 * np.pi * 2 * f * t)
               + 0.005 * rng.standard_normal(len(t)))
        parts.append(sig.astype(np.float32))
        parts.append(np.zeros(int(sr * gap_s), np.float32))
    wave = np.concatenate(parts)
    save_wav(path, wave, sr)
    return len(wave) / sr


def cold_file(model, wav, midi, device=None, prelude: str = "") -> dict:
    """The infer CLI's path in a fresh process: ``load_engine`` of
    ``model`` (a checkpoint with its config.yaml beside it), then
    ``transcribe_file`` of ``wav``, each timed inside that process (its
    start-up is left out). Returns {load_s, file_s, forwards, graphs}."""
    out = subprocess.run([sys.executable, "-c", COLD_CHILD, str(model), str(wav), str(midi),
                          str(device or ""), prelude],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"the cold run failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def _sync(engine) -> None:
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def bench_file_to_file(engine, config, state, workdir: pathlib.Path, n_phrases: int):
    """WAV file -> MIDI file wall clock (decode, slicer, buckets, device,
    assembly, SMF write), best of 3 after two warm-ups (a bucket's first run
    is eager, its second captures); the same with the next song's host prep
    on a worker thread (best of 2 runs of 4 songs); the device-only time of
    the same chunk groups, device-resident; the host code alone; and the
    cold file (``cold_file``: ``state`` saved as a checkpoint with the
    config). Returns (file_rtf, host_fraction, host_compute_fraction,
    stream_rtf, cold)."""
    wav_path = workdir / "song.wav"
    midi_path = workdir / "song.mid"
    sr = config["audio_sample_rate"]
    audio_seconds = make_song_wav(wav_path, sr, n_phrases=n_phrases)

    def prep(_=None):
        waveform, _sr = load_wav(wav_path, sr=sr, mono=True)
        return SilenceSlicer(sr=sr, max_sil_kept=MAX_SIL_KEPT_MS).slice(waveform)

    def run_once():
        chunks = prep()
        segments = engine.infer([c["waveform"] for c in chunks])
        build_midi_file([c["offset"] for c in chunks], segments, tempo=120).save(midi_path)
        return chunks, segments

    run_once()
    chunks, segments = run_once()  # captures every bucket it touches
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run_once()
        best = min(best, time.perf_counter() - t0)

    n_songs, stream_rtf = 4, 0.0
    for _ in range(2):
        with ThreadPoolExecutor(max_workers=1) as pool:
            futures = [pool.submit(prep, i) for i in range(n_songs)]
            t0 = time.perf_counter()
            for fut in futures:
                cs = fut.result()
                segs = engine.infer([c["waveform"] for c in cs])
                build_midi_file([c["offset"] for c in cs], segs, tempo=120).save(midi_path)
            stream_rtf = max(stream_rtf, n_songs * audio_seconds / (time.perf_counter() - t0))

    # device-only time of infer()'s own groups, inputs already on the device
    groups, _ = engine.bucket_groups([c["waveform"] for c in chunks])
    dev_inputs = [engine.stage_inputs(audio, mask)[:2] for _, audio, mask in groups]
    _sync(engine)

    def run_device():
        outs = [engine.run_bucket_staged(a, m) for a, m in dev_inputs]
        _sync(engine)
        return outs

    run_device()
    t0 = time.perf_counter()
    run_device()
    device_time = time.perf_counter() - t0

    host_compute_time = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        cs = prep()
        for c in cs:
            encode_wire(decimate_wire(c["waveform"], engine.wire_factor), engine.wire)
        build_midi_file([c["offset"] for c in cs], segments, tempo=120).save(midi_path)
        host_compute_time = min(host_compute_time, time.perf_counter() - t0)

    host_fraction = max(0.0, 1.0 - device_time / best)
    host_compute_fraction = min(host_fraction, host_compute_time / best)

    save_yaml(dict(config, pl_trainer_precision="bf16"), workdir / "config.yaml")
    model = save_checkpoint(workdir / "model.pt", state)
    cold = cold_file(model, wav_path, midi_path, device=engine.device)
    cold["rtf"] = audio_seconds / cold["file_s"]
    return audio_seconds / best, host_fraction, host_compute_fraction, stream_rtf, cold


def card() -> dict:
    """The card as nvidia-smi names it, with its power limit, and the count."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    name, power = (s.strip() for s in smi.stdout.strip().splitlines()[0].split(","))
    return {"name": name, "power_limit": power, "count": torch.cuda.device_count()}


def measure(device=None, B: int = 32, T: int = 1024, iters: int = 5, phrases: int = 32,
            file_phases: bool = True) -> dict:
    """The bench's result dict (see the module docstring)."""
    device = resolve_device(device)
    engine, config, state = build_engine(device)
    sr = config["audio_sample_rate"]
    hop_native = engine.hop * engine.wire_factor
    n_samples = T * hop_native - 1
    rng = np.random.default_rng(0)
    t = np.arange(n_samples) / sr
    audio = np.stack([(0.3 * np.sin(2 * np.pi * (220 + 40 * i) * t)
                       + 0.01 * rng.standard_normal(n_samples)).astype(np.float32)
                      for i in range(B)])
    if engine.wire_factor > 1:
        audio = np.stack([decimate_wire(row, engine.wire_factor) for row in audio])
        audio = audio[:, :T * engine.hop - 1]
    mask = np.ones((B, T), bool)
    wire_audio = encode_wire(audio, engine.wire)

    def force(out):
        return out["n_notes"].cpu()

    for _ in range(2):  # the bucket's first run is eager, its second captures its graph
        force(engine.run_bucket(wire_audio, mask))
    audio_seconds = B * n_samples / sr
    batches = [(wire_audio, mask)] * iters
    rtf = serial_rtf = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        force(engine.dispatch_staged(batches)[-1])
        rtf = max(rtf, audio_seconds * iters / (time.perf_counter() - t0))
    for _ in range(3):
        t0 = time.perf_counter()
        force(engine.dispatch_staged(batches, depth=0)[-1])
        serial_rtf = max(serial_rtf, audio_seconds * iters / (time.perf_counter() - t0))

    a_dev, m_dev, _ = engine.stage_inputs(wire_audio, mask)
    _sync(engine)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = engine.run_bucket_staged(a_dev, m_dev)
    force(out)
    compute_rtf = audio_seconds * iters / (time.perf_counter() - t0)

    file_rtf, host_fraction, host_compute_fraction, stream_rtf = 0.0, 1.0, 1.0, 0.0
    cold = {"rtf": 0.0, "load_s": 0.0}
    if file_phases:
        with tempfile.TemporaryDirectory(prefix="some_tpu_torch_bench_") as tmp:
            (file_rtf, host_fraction, host_compute_fraction, stream_rtf,
             cold) = bench_file_to_file(engine, config, state, pathlib.Path(tmp), phrases)

    where = card() if device.type == "cuda" else "cpu"
    on = (f"one CUDA graph per bucket, 1 {where['name']}" if device.type == "cuda"
          else "eager, the CPU")
    args = config["midi_extractor_args"]
    result = {
        "metric": "inference_rtf_x_realtime",
        "value": rtf,
        "unit": (f"audio-sec/sec (full wav->notes pipeline incl. host->device transfer, "
                 f"double-buffered serving dispatch, {on}, bf16 "
                 f"{args['lay']}x{args['dim']} conformer, B={B} T={T})"),
        "vs_baseline": rtf / BASELINE_RTF,
        "baseline": "300x real time, the reference README's RTX 3080 Ti figure",
        "serial_rtf": serial_rtf,
        "compute_only_rtf": compute_rtf,
        "e2e_file_rtf": file_rtf,
        "e2e_file_stream_rtf": stream_rtf,
        "e2e_file_cold_rtf": cold["rtf"],
        "cold_load_s": cold["load_s"],
        "file_host_fraction": host_fraction,
        "file_host_compute_fraction": host_compute_fraction,
        "wire": engine.wire,
        "wire_sr": engine.wire_sr,
        "mel_method": config["mel_method"],
        "quantize": config["quantize"],
        "weight_bytes": engine.weight_bytes,
        "device": where,
    }
    if engine.wire_decision is not None:
        result["wire_decision"] = engine.wire_decision
    print(f"| bench: {engine.graphs_captured} graphs captured, {engine.forwards} forwards",
          file=sys.stderr)
    return result


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="RTF of the port's waveform -> notes path")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; raises without a card)")
    args = parser.parse_args(argv)
    result = measure(args.device, B=_env_int("SOME_BENCH_B", 32),
                     T=_env_int("SOME_BENCH_T", 1024), iters=_env_int("SOME_BENCH_ITERS", 5),
                     phrases=_env_int("SOME_BENCH_PHRASES", 32),
                     file_phases=os.environ.get("SOME_BENCH_FILE", "1") == "1")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
