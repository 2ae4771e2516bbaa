#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``some_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:
  1. device: requires CUDA, prints the card's name and power limit;
  2. build: compiles every kernel under some_tpu_torch/csrc with nvcc;
  3. K1 (depthwise conv) against its plain version, bf16 and f32;
  4. K2 (flash attention) against its plain version, bf16 and f32;
  5. the main path: ``some_tpu_torch.infer`` at production geometry
     (configs/midi_conformer.yaml: 8 dual-stream layers, dim 512, 8 x 64
     heads, k=31), random weights from a seed, on synthetic songs, in bf16
     and in 32-true, through the kernels and through the plain versions;
     counts kernel launches and compares the notes.
Prints one JSON line of kernel measurements, one of main-path results and,
last, ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
SR = 44100
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 CUDA cores


def log(*args):
    print(*args, flush=True)


def median_ms(torch, fn, reps=20, warmup=3):
    """CUDA-event median of one call of ``fn``, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, flops, peak_flops):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak_flops * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def bf16_ulp(torch, ref):
    """Spacing of bfloat16 numbers at each |ref| (8 significant bits)."""
    _, exponent = torch.frexp(ref.float().abs())
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), exponent - 8)


def check_depthwise(torch):
    import torch.nn.functional as F
    from some_tpu_torch.ops.depthwise import depthwise_conv1d, depthwise_conv1d_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for shape in ((8, 1024, 512), (1, 32768, 512)):
        for dtype in (torch.bfloat16, torch.float32):
            B, T, C = shape
            K = 31
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = (torch.randn((K, C), generator=gen, device="cuda") * 0.1).to(dtype)
            got = depthwise_conv1d(x, w)
            want = depthwise_conv1d_plain(x, w)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            max_diff = float(diff.max())
            if dtype == torch.float32:
                ok = max_diff <= 1e-5
                tol = "max|d| <= 1e-5"
            else:
                ok = bool((diff <= bf16_ulp(torch, want)).all())
                tol = "|d| <= 1 bf16 ulp"
            log(f"K1 depthwise {list(shape)} {str(dtype)[6:]}: max|d| {max_diff:.3e} ({tol}): "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 depthwise disagrees with its plain version at "
                                     f"{shape} {dtype}: max|d| {max_diff}")
            # the library yardstick: cuDNN's grouped conv in true f32 (TF32 off
            # at the top of this script), channels first as cuDNN wants them
            xc = x.transpose(1, 2).contiguous()
            wc = w.t().unsqueeze(1).contiguous()
            itemsize = x.element_size()
            bound_ms, bound_by = bound((2 * B * T * C + K * C) * itemsize, 2 * B * T * C * K,
                                       PEAK_FLOPS["float32"])
            rows.append({
                "shape": list(shape), "dtype": str(dtype)[6:], "max_abs_diff": max_diff,
                "kernel_ms": median_ms(torch, lambda: depthwise_conv1d(x, w)),
                "plain_ms": median_ms(torch, lambda: depthwise_conv1d_plain(x, w), reps=5),
                "library_ms": median_ms(torch, lambda: F.conv1d(xc, wc, padding=K // 2,
                                                               groups=C)),
                "bound_ms": bound_ms, "bound_by": bound_by})
            del x, w, got, want, diff, xc, wc
    return rows


def attention_tolerance(torch, want):
    """Allowed |kernel - plain| for each element of ``want`` (the plain
    output on the rows compared). f32: 1e-5. bf16: both versions round the
    output to bf16, so a value may land one ulp apart, and they round the
    probabilities to bf16 at different points (the kernel before it
    normalizes, the plain version after), which adds noise of about 2e-3 x
    the output's RMS; so 2 bf16 ulp of |want| plus 0.02 x RMS(want)."""
    if want.dtype == torch.float32:
        return torch.full_like(want, 1e-5)
    want = want.float()
    return 2 * bf16_ulp(torch, want) + 0.02 * float(want.pow(2).mean().sqrt())


def check_attention(torch):
    import torch.nn.functional as F
    from some_tpu_torch.ops.attention import attention_plain, flash_attention

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for shape in ((8, 8, 1024, 64), (1, 8, 8192, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            B, H, T, D = shape
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
            mask = torch.ones((B, T), dtype=torch.bool, device="cuda")
            mask[0, int(T * 0.7):] = False          # a padded tail
            if B > 1:
                mask[B - 1] = False                 # a batch-padding row
            scale = D ** -0.5
            got = flash_attention(q, k, v, mask, scale)
            want = attention_plain(q, k, v, mask, scale)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(got.float()).all())
            real = mask.any(dim=1)
            ok = finite
            worst = {}
            for rows_name, sel in (("real", real), ("all-masked", ~real)):
                if not sel.any():
                    continue
                d = (got[sel].float() - want[sel].float()).abs()
                tol = attention_tolerance(torch, want[sel])
                ok = ok and bool((d <= tol).all())
                worst[rows_name] = (float(d.max()), float((d / tol).max()))
            max_diff, max_ratio = worst["real"]
            max_diff_empty = worst.get("all-masked", (0.0, 0.0))[0]
            tol_text = ("|d| <= 1e-5" if dtype == torch.float32 else
                        "|d| <= 2 bf16 ulp + 0.02 RMS")
            log(f"K2 attention {list(shape)} {str(dtype)[6:]}: real rows max|d| {max_diff:.3e}, "
                f"max |d|/tol {max_ratio:.3f} ({tol_text}); all-masked row max|d| "
                f"{max_diff_empty:.3e}; finite {finite}: {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K2 attention disagrees with its plain version at "
                                     f"{shape} {dtype}: {worst}, finite {finite}")
            # the library yardstick: SDPA, on a mask with no all-False row (it
            # would give NaN there)
            sdpa_mask = (mask | ~real[:, None])[:, None, None, :]
            itemsize = q.element_size()
            bound_ms, bound_by = bound(4 * B * H * T * D * itemsize + B * T,
                                       4 * B * H * T * T * D, PEAK_FLOPS[str(dtype)[6:]])
            rows.append({
                "shape": list(shape), "dtype": str(dtype)[6:], "max_abs_diff": max_diff,
                "max_abs_diff_all_masked_row": max_diff_empty, "max_diff_over_tol": max_ratio,
                "kernel_ms": median_ms(torch, lambda: flash_attention(q, k, v, mask, scale),
                                       reps=10),
                "plain_ms": median_ms(torch, lambda: attention_plain(q, k, v, mask, scale),
                                      reps=5),
                "library_ms": median_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=sdpa_mask), reps=10),
                "bound_ms": bound_ms, "bound_by": bound_by})
            del q, k, v, got, want
            torch.cuda.empty_cache()
    return rows


MATMUL_KERNEL_NAMES = ("gemm", "cutlass", "sm90_", "cublas", "nvjet")


def profile_pass(torch, run):
    """Device time of one warm pass by kernel, from torch.profiler. The
    profiler's own overhead is inside ``wall_s``: the busy share that counts
    divides ``device_ms`` by an unprofiled pass's wall time (the caller's)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    groups = {}
    for e in kernels:
        name = e.key.lower()
        group = ("flash_attention" if "flash_fwd" in name else
                 "depthwise_conv1d" if "depthwise_fwd" in name else
                 "matmul" if any(t in name for t in MATMUL_KERNEL_NAMES)
                 else "fft" if "fft" in name else "other")
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_s": wall_s, "device_ms": total_us / 1e3,
            "busy_share_of_profiled_wall": total_us / 1e6 / wall_s if total_us else None,
            "by_group_ms": groups,
            "top": [{"kernel": e.key[:90], "ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in top]}


def make_song(seed: int, phrases: int, notes_per_phrase: int = 12) -> np.ndarray:
    """Sine melody with vibrato in phrases parted by 0.8 s of silence, in the
    style of tests/test_prod_parity.py::make_song."""
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


def main_path(torch, workdir: pathlib.Path):
    from some_tpu_torch.audio.wavio import save_wav
    from some_tpu_torch.compat.from_jax import jax_params_to_state_dict, random_jax_variables
    from some_tpu_torch.config import read_full_config, save_yaml
    from some_tpu_torch.infer import load_engine, transcribe_file
    from some_tpu_torch.inference.base_infer import pick_bucket
    from some_tpu_torch.nn.conformer import DepthwiseConv1d
    from some_tpu_torch.nn.model import build_midi_extractor
    from some_tpu_torch.ops.attention import flash_attention
    from some_tpu_torch.ops.depthwise import depthwise_conv1d
    from some_tpu_torch.utils.checkpoint import save_checkpoint
    from some_tpu_torch.utils.midi_file import MidiFile, midi_notes_to_arrays
    from some_tpu_torch.utils.note_f1 import note_f1

    kernels = {"depthwise_conv1d": depthwise_conv1d, "flash_attention": flash_attention}
    config = read_full_config(REPO / "configs" / "midi_conformer.yaml")
    config["transfer_dtype"] = "int16"
    args = config["midi_extractor_args"]
    blocks = 2 * args["lay"] + 2
    log(f"main path: configs/midi_conformer.yaml, lay {args['lay']} dim {args['dim']} "
        f"heads {args['attention_heads']}x{args['attention_heads_dim']} k {args['kernel_size']}, "
        f"{blocks} conformer blocks")

    # weights: numpy from a seed, in the JAX variable layout, carried across
    variables = random_jax_variables(build_midi_extractor(config), seed=314159)
    state = jax_params_to_state_dict(variables["params"], variables["batch_stats"])
    ckpt = save_checkpoint(workdir / "model.pt", state, {"seed": 314159})
    del state, variables
    dirs = {}
    for precision in ("bf16", "32-true"):
        for impl in ("kernel", "plain"):
            d = workdir / f"{precision}-{impl}"
            d.mkdir()
            cfg = dict(config, pl_trainer_precision=precision)
            if impl == "plain":
                cfg["attention_impl"] = "xla"
            save_yaml(cfg, d / "config.yaml")
            os.symlink(ckpt, d / "model.pt")
            dirs[precision, impl] = d / "model.pt"

    # three songs of about 30 s, and one whose single phrase is longer than
    # the 4096-frame bucket
    songs = [make_song(1000 + i, phrases=5) for i in range(3)]
    songs.append(make_song(1003, phrases=1, notes_per_phrase=120))
    long_frames = len(songs[-1]) // config["hop_size"] + 1
    if pick_bucket(long_frames) <= 4096:
        raise AssertionError(f"long song has {long_frames} frames, not above bucket 4096")
    wavs = []
    for i, song in enumerate(songs):
        wavs.append(workdir / f"song{i}.wav")
        save_wav(wavs[-1], song, SR)
    audio_s = sum(len(s) for s in songs) / SR
    log(f"songs: {[round(len(s) / SR, 2) for s in songs]} s, {audio_s:.2f} s in all; the long "
        f"one has {long_frames} frames (bucket {pick_bucket(long_frames)})")

    def run_pass(engine, tag):
        t0 = time.perf_counter()
        paths = [transcribe_file(engine, wav, workdir / f"{tag}-{i}.mid")
                 for i, wav in enumerate(wavs)]
        torch.cuda.synchronize()
        return paths, time.perf_counter() - t0

    def counts():
        return {name: fn.launches for name, fn in kernels.items()}

    def reset():
        for fn in kernels.values():
            fn.launches = 0

    result = {}
    main_launches = None
    for precision in ("bf16", "32-true"):
        engine = load_engine(dirs[precision, "kernel"], device="cuda", quiet=True)
        engine.forwards = 0
        reset()
        midis, first_s = run_pass(engine, f"{precision}-kernel")
        launched = counts()
        forwards = engine.forwards
        log(f"{precision} kernel path: {forwards} forwards, launches {launched}")
        for name, n in launched.items():
            if n != blocks * forwards or forwards == 0:
                raise AssertionError(f"{name}: {n} launches for {forwards} forwards, want "
                                     f"{blocks} per forward")
        if main_launches is None:
            main_launches = launched
        notes = [len(MidiFile.load(m).notes()) for m in midis]
        if min(notes) == 0:
            raise AssertionError(f"{precision}: a MIDI file with no notes: {notes}")
        warm = [run_pass(engine, f"{precision}-warm")[1] for _ in range(3)]
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        profiled = profile_pass(torch, lambda: run_pass(engine, f"{precision}-profiled"))
        profiled["busy_share_of_warm_wall"] = (profiled["device_ms"] / 1e3
                                               / statistics.median(warm))
        log(f"{precision} profile: " + json.dumps(profiled))
        del engine
        torch.cuda.empty_cache()

        plain = load_engine(dirs[precision, "plain"], device="cuda", quiet=True)
        for module in plain.model.modules():
            if isinstance(module, DepthwiseConv1d):
                module.impl = "plain"
        reset()
        plain_midis, plain_first_s = run_pass(plain, f"{precision}-plain")
        plain_warm = [run_pass(plain, f"{precision}-plain-warm")[1] for _ in range(3)]
        if any(counts().values()):
            raise AssertionError(f"the plain path launched kernels: {counts()}")
        del plain
        torch.cuda.empty_cache()

        f1s = []
        for a, b in zip(plain_midis, midis):
            f1s.append(note_f1(midi_notes_to_arrays(MidiFile.load(a)),
                               midi_notes_to_arrays(MidiFile.load(b)),
                               onset_tolerance=0.05, pitch_tolerance=0.5).f1)
        need = 1.0 if precision == "32-true" else 0.95
        log(f"{precision}: notes per song {notes}; kernel-vs-plain note F1 {f1s} "
            f"(need >= {need}); RTF first {audio_s / first_s:.2f}x, warm median "
            f"{audio_s / statistics.median(warm):.2f}x; plain path first "
            f"{audio_s / plain_first_s:.2f}x, warm median "
            f"{audio_s / statistics.median(plain_warm):.2f}x; device busy "
            f"{profiled['busy_share_of_warm_wall']:.3f} of the warm median wall")
        if min(f1s) < need:
            raise AssertionError(f"{precision}: kernel-vs-plain note F1 {f1s} below {need}")
        result[precision] = {
            "forwards": forwards, "launches": launched, "notes": notes, "f1_vs_plain": f1s,
            "audio_s": audio_s, "first_s": first_s, "warm_s": warm,
            "rtf_first": audio_s / first_s, "rtf_warm_median": audio_s / statistics.median(warm),
            "plain_first_s": plain_first_s, "plain_warm_s": plain_warm,
            "plain_rtf_warm_median": audio_s / statistics.median(plain_warm),
            "peak_gib": peak_gb, "profile": profiled}
    return result, main_launches, blocks


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke test needs a GPU",
              file=sys.stderr)
        return 1
    if not (REPO / "some_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no some_tpu_torch/ beside {__file__}; run it from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    # every f32 comparison below is in true f32: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    from some_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build()
    log(f"build: {len(libs)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        report = path.with_suffix(".log").read_text().splitlines()
        regs = [int(line.split("Used ")[1].split()[0]) for line in report if "registers" in line]
        spills = sum(int(line.split(" bytes spill stores")[0].split()[-1])
                     for line in report if "spill stores" in line)
        log(f"  {name}: {len(regs)} kernel variants, at most {max(regs)} registers, "
            f"{spills} bytes of spill stores")

    dw_rows = check_depthwise(torch)
    attn_rows = check_attention(torch)

    with tempfile.TemporaryDirectory(prefix="some_tpu_torch_smoke_") as tmp:
        main_result, launches, blocks = main_path(torch, pathlib.Path(tmp))

    def entry(name, source, replaces, rows):
        head = rows[0]  # [8, ...] bf16: the production dtype at a main-path batch
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "launches_per_forward": blocks,
                "max_abs_err": max(r["max_abs_diff"] for r in rows),
                "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "shape": head["shape"],
                "dtype": head["dtype"], "card": card, "shapes": rows}

    print(json.dumps({"kernels": [
        entry("depthwise_conv1d", "some_tpu_torch/csrc/depthwise_conv.cu",
              "some_tpu/ops/depthwise.py:24", dw_rows),
        entry("flash_attention", "some_tpu_torch/csrc/flash_attention.cu",
              "some_tpu/ops/attention.py:61", attn_rows)]}), flush=True)
    print(json.dumps({"main_path": main_result, "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
