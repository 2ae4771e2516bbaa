"""What eager dispatch costs the engine on the card: RTF with and without CUDA graphs.

At production geometry (``configs/midi_conformer.yaml``, bf16, random
weights from a seed), four synthetic songs of chip_smoke.py's kind (three
phrases' songs of about 30 s and one long phrase) are sliced as the infer
CLI slices them and run through ``engine.infer``: under eager dispatch (each
forward launches its kernels from Python, through the kernel wrappers and
their ops) and under graph dispatch (one CUDA graph per bucket, captured by
``prewarm``), in turns, ``--reps`` times each; plus the CUDA-event time of
one eager forward of an [8, 512] bucket. Prints one JSON line.

``--tree`` measures the ``some_tpu_torch`` of another checkout (its kernels
built into that checkout's ``build/``), so that two versions are compared
in one process's conditions, one after the other, on one card. In a
checkout with the kernels' ``torch.library`` ops (``ops/library.py``) it
also times the host side of one call of the K1 and K2 wrappers through
their ops against the raw launch inside them:

    python some_tpu_torch/bench_dispatch.py [--tree CHECKOUT] [--reps 7]
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

SR = 44100


def song(seed: int, phrases: int, notes_per_phrase: int = 12) -> np.ndarray:
    """Sine melody with vibrato in phrases parted by 0.8 s of silence."""
    rng = np.random.default_rng(seed)
    segs = []
    for p in range(phrases):
        for _ in range(notes_per_phrase):
            f = 440.0 * 2 ** (rng.integers(-12, 13) / 12)
            dur = float(rng.uniform(0.3, 0.6))
            t = np.arange(int(SR * dur)) / SR
            vib = 0.004 * np.sin(2 * np.pi * 5.5 * t)
            segs.append(0.45 * np.sin(2 * np.pi * f * (t + vib * t)))
        if p < phrases - 1:
            segs.append(np.zeros(int(SR * 0.8)))
    return np.concatenate(segs).astype(np.float32)


def wrapper_host_us(torch, calls: int = 400) -> dict:
    """Host time of one no-grad call of the K1 and K2 wrappers, which go
    through their ``torch.ops.some_tpu`` op, against the raw launch that the
    op's CUDA implementation makes (what a wrapper called before the ops
    existed): the median over ``calls`` calls of a host clock around each,
    no synchronization between them, at [1, 512, 512] and [1, 8, 512, 64]
    bf16, in microseconds."""
    from some_tpu_torch.ops import attention as A
    from some_tpu_torch.ops import depthwise as W

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1, 512, 512, generator=gen, device="cuda").bfloat16()
    w = torch.randn(31, 512, generator=gen, device="cuda").bfloat16()
    q, k, v = (torch.randn(1, 8, 512, 64, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    mask = torch.ones(1, 512, dtype=torch.bool, device="cuda")
    fns = {"depthwise_conv1d": lambda: W.depthwise_conv1d(x, w),
           "depthwise_conv1d_raw": lambda: W._launch(x, w, W.depthwise_conv1d),
           "flash_attention": lambda: A.flash_attention(q, k, v, mask, 0.125),
           "flash_attention_raw": lambda: A._launch(q, k, v, mask, 0.125)}
    out = {}
    with torch.inference_mode():
        for _ in range(3):  # in turns, three rounds; the median of the rounds' medians
            for name, fn in fns.items():
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
                times = []
                for _ in range(calls):
                    t0 = time.perf_counter()
                    fn()
                    times.append((time.perf_counter() - t0) * 1e6)
                torch.cuda.synchronize()
                out.setdefault(name, []).append(statistics.median(times))
    return {name: statistics.median(v) for name, v in out.items()}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="eager vs graph dispatch RTF of the engine")
    parser.add_argument("--tree", default=str(pathlib.Path(__file__).resolve().parent.parent),
                        help="checkout whose some_tpu_torch is measured (default: this one)")
    parser.add_argument("--reps", type=int, default=7, help="timed passes of each dispatch")
    args = parser.parse_args(argv)
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    from some_tpu_torch.compat.from_jax import jax_params_to_state_dict, random_jax_variables
    from some_tpu_torch.config import read_full_config
    from some_tpu_torch.inference.base_infer import set_dispatch
    from some_tpu_torch.inference.me_infer import MIDIExtractionInference
    from some_tpu_torch.inference.pipeline import slice_waveform
    from some_tpu_torch.nn.model import build_midi_extractor
    from some_tpu_torch.ops import _build

    if not pathlib.Path(_build.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {_build.__file__}, not the package of {tree}")
    _build.build()
    config = dict(read_full_config(tree / "configs" / "midi_conformer.yaml"),
                  transfer_dtype="int16")
    variables = random_jax_variables(build_midi_extractor(config), seed=314159)
    state = jax_params_to_state_dict(variables["params"], variables["batch_stats"])
    engines = {mode: MIDIExtractionInference.from_state_dict(config, state, device="cuda")
               for mode in ("eager", "graph")}
    set_dispatch(engines["eager"], "eager")
    songs = [song(1000 + i, phrases=5) for i in range(3)] + [song(1003, 1, 120)]
    chunks = [c["waveform"] for s in songs for c in slice_waveform(s, SR)]
    audio_s = sum(len(s) for s in songs) / SR
    groups, _ = engines["graph"].bucket_groups(chunks)
    engines["graph"].prewarm(sorted({mask.shape[1] for _, _, mask in groups}),
                             rows=sorted({mask.shape[0] for _, _, mask in groups}))
    for engine in engines.values():  # first passes: every bucket's first-call caches
        engine.infer(chunks)
    walls = {"eager": [], "graph": []}
    for i in range(args.reps):
        for mode in ("eager", "graph") if i % 2 == 0 else ("graph", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engines[mode].infer(chunks)
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
    eager = engines["eager"]
    rows = np.zeros((8, 512 * eager.hop - 1), np.int16)
    mask = np.ones((8, 512), bool)
    staged = eager.stage_inputs(rows, mask)
    times = []
    for _ in range(23):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        eager.run_bucket_staged(*staged)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    has_ops = (tree / "some_tpu_torch" / "ops" / "library.py").exists()
    wrapper_us = wrapper_host_us(torch) if has_ops else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(json.dumps({
        "tree": str(tree), "ops_library": has_ops,
        "audio_s": audio_s, "chunks": len(chunks), "walls_s": walls,
        "rtf": {mode: audio_s / statistics.median(w) for mode, w in walls.items()},
        "eager_forward_8x512_ms": statistics.median(times[3:]),
        "wrapper_host_us": wrapper_us,
        "card": smi.stdout.strip(), "pid": os.getpid()}), flush=True)


if __name__ == "__main__":
    main()
