#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``some_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:
  1. device: requires CUDA, prints the card's name and power limit;
  2. build: compiles every kernel under some_tpu_torch/csrc with nvcc, all
     sources at once, and prints each one's registers and spills; counts
     the tensor-core instructions (HMMA, HGMMA) of the bf16 kernels that
     run on the tensor cores, in the SASS of the built libraries
     (cuobjdump), and raises if one has none;
  3. every kernel against its plain version on the card, with its times:
     K1 (depthwise conv) forward, dx, dw; K2 (flash attention) forward,
     forward with statistics, dk/dv, dq; K3 (fused LN -> FFN -> residual);
     K4 (splash attention) forward, forward with log-sum-exp, dk/dv, dq;
     for the tensor-core kernels, the time against SDPA (K3: the unfused
     eager chain) and the bound;
  4. the infer path: ``some_tpu_torch.infer`` at production geometry
     (configs/midi_conformer.yaml: 8 dual-stream layers, dim 512, 8 x 64
     heads, k=31), random weights from a seed, on synthetic songs, in bf16
     and in 32-true: the engine's default dispatch (one CUDA graph per
     bucket, after ``prewarm``), its eager dispatch and the plain versions;
     counts kernel launches (captures; eager forwards), holds the graph
     path's probs and bounds bit for bit against the eager path's, counts
     the hand-written kernels of each bucket's graph (its kernel nodes, as
     the CUDA driver prints the graph) and of one profiled replay, and compares
     the notes. Twice: the default kernels (K1, K2), then the opt-in
     configuration (``fuse_ffn: true``, ``attention_impl: splash``: K1, K3,
     K4);
  5. the train path: ``Trainer.fit`` at production width with launch
     counts per step and per validation forward, for the default and the
     opt-in configuration, each followed by inference from its checkpoint;
     a kernel-vs-plain train step for each; an f32 loss that falls;
  6. what users bring: ``quantize: int8`` (one cuBLASLt int8 product held
     bit for bit against int64 and timed against bf16; the infer path as in
     4 for the default configuration in bf16 and f32 and the opt-in one in
     bf16, whose graphs hold no K3; notes also against the unquantized
     engine; resident weight bytes); ``mel_method: dft`` (its log-mel
     against rfft on the card, notes, the mels' device time); the engine's
     oversize split (frame buckets cut at 256) graph vs eager; the discrete
     model (configs/discrete.yaml, 129 classes) through the infer CLI and
     ``Trainer.fit`` in bf16 with launch counts per step; a reference
     Lightning checkpoint (tests/torch_oracle.py's ``OracleModel`` at
     production width) through ``load_engine``, its f32 forward against
     ``OracleModel``'s;
  7. the engine in default bf16: a prewarm of every bucket up to 4096
     frames at rows 1-8 (its seconds and memory), and the infer CLI's cold
     case, a fresh process's ``load_engine`` + ``transcribe_file``, under
     the default dispatch, eager dispatch and capture on first use;
  8. the port's bench (``some_tpu_torch.bench``), shortened.
Each phase's seconds are printed, and the total.
Prints the bench's JSON line, one JSON line of kernel measurements, one of
path results and, last, ``{"ok": true, "device": {...}}``. Imports nothing
of JAX.

Every kernel row's ``ms`` and ``library_ms`` is one call's CUDA-event time,
host work included where the card waits for it. K1's rows add the card's
time alone (``device_ms``, ``library_device_ms``: the durations of a call's
kernels, from torch.profiler) and the wrapper's host time (``host_ms``).
"""
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

START = time.perf_counter()
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


def device_ms(torch, fn, calls=20, warmup=3):
    """Time on the card of one call of ``fn``, in ms: the durations of the
    kernels it launches, summed (torch.profiler, over ``calls`` calls). The
    wrapper's host work, launch gaps and the CUDA events' own overhead, which
    ``median_ms`` includes, fall outside. None where the profiler recorded
    no kernel on the card."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    return total_us / calls / 1e3 if total_us > 0 else None


def host_ms(torch, fn, calls=50, warmup=3):
    """Host time of one call of ``fn``, in ms: the median over ``calls``
    calls, each timed on the host's clock, issued with no synchronization
    between them (the card's queue takes the launches)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def back_to_back_ms(torch, fn, calls=36, reps=5):
    """CUDA-event median over ``reps`` runs of ``calls`` calls of ``fn`` in a
    row, divided by ``calls``, in ms: the steady state of a forward that
    makes the same call many times, where the host prepares the next call
    while the card runs this one."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bound(nbytes, flops, peak_flops):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak_flops * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


# The bf16 kernels on the tensor cores (mma.sync on attention_mma.cuh's tile; K3 wgmma):
# (library, kernel name, wrapper)
TENSOR_CORE_KERNELS = (("flash_attention", "flash_fwd_mma_kernel", "flash_attention"),
                       ("flash_attention", "flash_fwd_stats_mma_kernel", "flash_attention_fwd_res"),
                       ("flash_attention_bwd", "flash_bwd_dkv_mma_kernel",
                        "flash_attention_bwd_dkv"),
                       ("flash_attention_bwd", "flash_bwd_dq_mma_kernel", "flash_attention_bwd_dq"),
                       ("splash_attention", "splash_fwd_mma_kernel", "splash_attention"),
                       ("splash_attention", "splash_fwd_mma_kernel", "splash_attention_fwd_res"),
                       ("splash_attention_bwd", "splash_bwd_dkv_mma_kernel",
                        "splash_attention_bwd_dkv"),
                       ("splash_attention_bwd", "splash_bwd_dq_mma_kernel",
                        "splash_attention_bwd_dq"),
                       ("fused_ffn", "fused_ffn_mma_kernel", "fused_ln_ffn_residual"))


def hmma_counts(libs, nvcc: str):
    """Tensor-core instructions per kernel variant in the SASS of the
    libraries that hold a tensor-core kernel (``cuobjdump -sass``): HMMA
    (mma.sync) and HGMMA (wgmma, K3's), keyed by mangled name; the
    CUDA-core kernels beside them count 0. Raises if a tensor-core kernel
    has none."""
    cuobjdump = str(pathlib.Path(nvcc).parent / "cuobjdump")
    counts = {}
    for lib in sorted({lib for lib, _, _ in TENSOR_CORE_KERNELS}):
        sass = subprocess.run([cuobjdump, "-sass", str(libs[lib])], capture_output=True,
                              text=True, check=True).stdout
        for block in sass.split("Function : ")[1:]:
            counts[block.split()[0]] = sum("HMMA" in line or "HGMMA" in line
                                           for line in block.splitlines())
    for _, kernel, _ in TENSOR_CORE_KERNELS:
        found = {n: c for n, c in counts.items() if kernel in n}
        if not found or min(found.values()) == 0:
            raise AssertionError(f"{kernel}: no tensor-core instruction in its SASS ({found})")
    return counts


def kernel_registers(report: str):
    """Registers of each kernel variant in an ``nvcc -Xptxas -v`` report,
    keyed by mangled name."""
    regs, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "registers" in line and name is not None:
            regs[name] = int(line.split("Used ")[1].split()[0])
            name = None
    return regs


def kernel_spills(report: str):
    """Bytes of spill stores of each kernel variant in an ``nvcc -Xptxas -v``
    report, keyed by mangled name."""
    spills, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line and name is not None:
            spills[name] = int(line.split(" bytes spill stores")[0].split()[-1])
    return spills


def depthwise_variant(name: str):
    """'fwd bf16 K=31' for a mangled K1 kernel name, None for another kernel."""
    kernel = next((k for k in ("fwd", "dw_partial", "dw_reduce")
                   if f"depthwise_{k}_kernel" in name), None)
    if kernel is None:
        return None
    args = name.split(f"depthwise_{kernel}_kernel")[1]
    taps = args.split("Li")[1].split("E")[0] if "Li" in args else "-"
    return f"{kernel} {'bf16' if 'bfloat16' in args else 'f32'} K={taps}"


def report_depthwise_variants(lib: pathlib.Path, nvcc: str):
    """Registers and spills of every K1 kernel variant, and the instruction
    mix of each variant's SASS (cuobjdump -sass): all instructions, and the
    FP32 arithmetic of the taps among them (FMUL + FADD in the forward, FFMA
    in the partials). Raises if a production variant (K = 31) spills."""
    report = lib.with_suffix(".log").read_text()
    regs, spills = kernel_registers(report), kernel_spills(report)
    short = {n: depthwise_variant(n) for n in regs if depthwise_variant(n)}
    log("K1 kernel variants (registers, bytes of spill stores): " + json.dumps(
        {short[n]: [regs[n], spills.get(n, 0)] for n in short}))
    bad = [short[n] for n in short if short[n].endswith("K=31") and spills.get(n, 0)]
    if bad:
        raise AssertionError(f"K1 production variants spill registers: {bad}")
    sass = subprocess.run([str(pathlib.Path(nvcc).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    mix = {}
    for block in sass.split("Function : ")[1:]:
        variant = depthwise_variant(block.split()[0])
        if variant is None or variant.startswith("dw_reduce"):
            continue
        ops = [m.group(1) for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", block)]
        mix[variant] = [len(ops), sum(op in ("FMUL", "FADD", "FFMA") for op in ops)]
    log("K1 SASS (instructions, of them FMUL/FADD/FFMA): " + json.dumps(mix))


def bf16_ulp(torch, ref):
    """Spacing of bfloat16 numbers at each |ref| (8 significant bits)."""
    _, exponent = torch.frexp(ref.float().abs())
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), exponent - 8)


def grad_tolerance(torch, want, rel, dtype=None):
    """Allowed |kernel - plain| for each element of ``want``: ``rel`` times
    the RMS of ``want`` (the sums run in another order, and the backward of
    attention takes rowsum(dO * O) where the plain autograd takes
    rowsum(P * dP)), plus 2 ulp of |want| in ``dtype``, the dtype of what is
    held against ``want`` (by default want's own): both round the result
    once, and a bf16 result held against an f32 reference is one rounding
    from it."""
    w = want.detach().float()
    _, exponent = torch.frexp(w.abs())
    bits = 8 if (dtype or want.dtype) == torch.bfloat16 else 24
    ulp = torch.where(w == 0, 0.0, torch.ldexp(torch.ones_like(w), exponent - bits))
    return 2 * ulp + rel * float(w.pow(2).mean().sqrt())


# K1's shapes: [8, 1024, 512] bf16 heads its rows in the kernels line; then one
# long sequence, the infer path's [8, 512, 512] and [1, 6144, 512], the train
# path's [8, 2048, 512]
DEPTHWISE_SHAPES = ((8, 1024, 512), (1, 32768, 512), (8, 512, 512), (1, 6144, 512),
                    (8, 2048, 512))


def fp32_floor_ms(torch, B, T, C, K, sm_clock_mhz):
    """K1 forward's FP32-instruction floor: one rounded multiply and one
    rounded add a tap and output (no fused multiply-add, to stay bit for bit
    with the plain version), 2 K B T C lane-operations over every SM's 128
    FP32 lanes at the card's maximum SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 2 * K * B * T * C / (sms * 128 * sm_clock_mhz * 1e6) * 1e3


def check_depthwise(torch, sm_clock_mhz):
    import torch.nn.functional as F
    from some_tpu_torch.ops.depthwise import depthwise_conv1d, depthwise_conv1d_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for shape in DEPTHWISE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            B, T, C = shape
            K = 31
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = (torch.randn((K, C), generator=gen, device="cuda") * 0.1).to(dtype)
            got = depthwise_conv1d(x, w)
            want = depthwise_conv1d_plain(x, w)
            torch.cuda.synchronize()
            max_diff = float((got.float() - want.float()).abs().max())
            # same arithmetic in the same order as the plain version: bit for bit
            ok = torch.equal(got, want)
            log(f"K1 depthwise {list(shape)} {str(dtype)[6:]}: max|d| {max_diff:.3e} (bit for "
                f"bit): {'ok' if ok else 'FAIL'}")
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
            floor_ms = fp32_floor_ms(torch, B, T, C, K, sm_clock_mhz)
            log(f"K1 depthwise {list(shape)} {str(dtype)[6:]}: bytes bound {bound_ms:.4f} ms, "
                f"FP32-instruction floor {floor_ms:.4f} ms (2 K B T C at {sm_clock_mhz} MHz)")
            library = lambda: F.conv1d(xc, wc, padding=K // 2, groups=C)  # noqa: E731
            rows.append({
                "shape": list(shape), "dtype": str(dtype)[6:], "max_abs_diff": max_diff,
                "kernel_ms": median_ms(torch, lambda: depthwise_conv1d(x, w)),
                "device_ms": device_ms(torch, lambda: depthwise_conv1d(x, w)),
                "host_ms": host_ms(torch, lambda: depthwise_conv1d(x, w)),
                "plain_ms": median_ms(torch, lambda: depthwise_conv1d_plain(x, w), reps=5),
                "library_ms": median_ms(torch, library),
                "library_device_ms": device_ms(torch, library),
                "bound_ms": bound_ms, "bound_by": bound_by, "fp32_floor_ms": floor_ms})
            del x, w, got, want, xc, wc
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


def key_pairs(mask):
    """The (query, key) pairs of one head that K2's function needs: in a row
    with a real key, every query against the real keys (a masked key's
    probability and gradients are exactly 0 there); in an all-masked row all
    T^2 (the masked keys carry the uniform average)."""
    T = mask.shape[1]
    real = mask.sum(dim=1).double()
    return int((T * real + (real == 0).double() * T * T).sum())


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
                                       4 * H * D * key_pairs(mask), PEAK_FLOPS[str(dtype)[6:]])
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
# (substring of the CUDA kernel's name, group), first match wins; the splash
# forward is one kernel with and without its log-sum-exp
KERNEL_GROUPS = (("flash_fwd_stats", "flash_attention_fwd_res"),
                 ("flash_fwd", "flash_attention"), ("flash_bwd_dkv", "flash_attention_bwd_dkv"),
                 ("flash_bwd_dq", "flash_attention_bwd_dq"),
                 ("splash_fwd", "splash_attention"), ("splash_bwd_dkv", "splash_attention_bwd_dkv"),
                 ("splash_bwd_dq", "splash_attention_bwd_dq"),
                 ("fused_ffn", "fused_ln_ffn_residual"),
                 ("depthwise_dw", "depthwise_conv1d_dw"), ("depthwise_fwd", "depthwise_conv1d"))


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
        group = next((g for key, g in KERNEL_GROUPS if key in name), None) or (
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


OPT_IN = {"fuse_ffn": True, "attention_impl": "splash"}


def infer_setup(workdir: pathlib.Path):
    """The production config, one checkpoint of random weights from a seed
    (numpy, in the JAX variable layout, carried across), and four synthetic
    songs as WAV files."""
    from some_tpu_torch.audio.wavio import load_wav, save_wav
    from some_tpu_torch.compat.from_jax import jax_params_to_state_dict, random_jax_variables
    from some_tpu_torch.config import read_full_config
    from some_tpu_torch.inference.base_infer import pick_bucket
    from some_tpu_torch.inference.pipeline import slice_waveform
    from some_tpu_torch.nn.model import build_midi_extractor
    from some_tpu_torch.utils.checkpoint import save_checkpoint

    config = read_full_config(REPO / "configs" / "midi_conformer.yaml")
    config["transfer_dtype"] = "int16"
    args = config["midi_extractor_args"]
    log(f"infer path: configs/midi_conformer.yaml, lay {args['lay']} dim {args['dim']} "
        f"heads {args['attention_heads']}x{args['attention_heads_dim']} k {args['kernel_size']}, "
        f"{2 * args['lay'] + 2} conformer blocks")
    variables = random_jax_variables(build_midi_extractor(config), seed=314159)
    state = jax_params_to_state_dict(variables["params"], variables["batch_stats"])
    ckpt = save_checkpoint(workdir / "model.pt", state, {"seed": 314159})
    del state, variables

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
    # the chunks the infer CLI makes of the songs (from the WAV files), and their buckets
    chunks = [c["waveform"] for wav in wavs
              for c in slice_waveform(load_wav(wav, sr=SR)[0], SR)]
    buckets = sorted({pick_bucket(len(c) // config["hop_size"] + 1) for c in chunks})
    log(f"songs: {[round(len(s) / SR, 2) for s in songs]} s, {audio_s:.2f} s in all; the long "
        f"one has {long_frames} frames (bucket {pick_bucket(long_frames)}); {len(chunks)} "
        f"chunks in buckets {buckets}")
    return {"config": config, "ckpt": ckpt, "wavs": wavs, "audio_s": audio_s,
            "blocks": 2 * args["lay"] + 2, "chunks": chunks, "buckets": buckets}


# copies and fills: a replay's static-input copies and output clones, and the
# zero fills that a capture issues as kernels where eager dispatch memsets
COPY_OR_FILL = ("memcpy", "memset", "direct_copy_kernel", "fillfunctor")
# the launch configuration that opens in a kernel node's label of the CUDA driver's DOT print
LAUNCH = "\\<\\<\\<"


def kernel_names(torch, run):
    """Launches on the card of one ``run()`` by kernel name (torch.profiler),
    copies and fills (COPY_OR_FILL) left out. A fill before and after the
    run, each behind a synchronize and 50 ms of idle card, keeps ``run``'s
    own launches off the ends of the session, where the profiler has
    dropped records (the first kernel of an eager forward, in one run)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1024, device="cuda").fill_(1.0)
        torch.cuda.synchronize()
        time.sleep(0.05)
        run()
        torch.cuda.synchronize()
        time.sleep(0.05)
        torch.zeros(1024, device="cuda").fill_(1.0)
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not any(word in e.key.lower() for word in COPY_OR_FILL)}


def hand_written(names: dict) -> dict:
    """Wrapper name -> launches of its hand-written kernel among ``names``."""
    out = {}
    for name, count in names.items():
        group = next((g for key, g in KERNEL_GROUPS if key in name.lower()), None)
        if group is not None:
            out[group] = out.get(group, 0) + count
    return out


def kernel_diff(replay: dict, forward: dict) -> dict:
    """Kernel name -> (replay count, eager forward count), where they differ.
    Kept as a record, not a check: torch.profiler loses or adds a record
    now and then (a replay one launch of a PyTorch elementwise kernel over
    an eager forward in some comparisons, an eager forward's cuFFT kernel
    missing in one), so the check is ``graph_kernel_nodes``."""
    return {k: (replay.get(k, 0), forward.get(k, 0)) for k in set(replay) | set(forward)
            if replay.get(k, 0) != forward.get(k, 0)}


def profiled_replay(torch, engine, staged, per_forward: dict, sessions: int = 5):
    """``kernel_names`` of one replay of a captured bucket, and the sessions
    it took: torch.profiler at times loses a run of a graph replay's kernel
    records, hand-written ones among them (16 of the 18 K1 and of the 18 K2
    in one replay on an H100 whose outputs matched eager dispatch bit for
    bit), so a session whose hand-written counts fall short of
    ``per_forward`` is profiled again, at most ``sessions`` times;
    ``graph_kernel_nodes`` counts the graph's kernels without the
    profiler."""
    for session in range(1, sessions + 1):
        names = kernel_names(torch, lambda: engine.run_bucket_staged(*staged))
        if hand_written(names) == per_forward:
            break
    return names, session


def graph_kernel_nodes(torch, engine, audio, mask) -> dict:
    """The kernel nodes of a bucket's graph by name, counted in the graph
    itself: the bucket is captured again with its cudaGraph_t kept
    (``CUDAGraph(keep_graph=True)``) and printed by the CUDA driver
    (``cuGraphDebugDotPrint``, verbose), one line a kernel node; the
    engine's own graph for the bucket is put back after."""
    import ctypes

    class KeptGraph(torch.cuda.CUDAGraph):
        def __new__(cls, keep_graph=False):
            return super().__new__(cls, True)

        def __init__(self, keep_graph=False):
            super().__init__(True)

    key = (engine.wire, *mask.shape)
    saved = engine._graphs.pop(key, None)
    plain_graph, torch.cuda.CUDAGraph = torch.cuda.CUDAGraph, KeptGraph
    try:
        engine.run_bucket(audio, mask)
    finally:
        torch.cuda.CUDAGraph = plain_graph
    kept = engine._graphs.pop(key)
    if saved is not None:
        engine._graphs[key] = saved
    driver = ctypes.CDLL("libcuda.so.1")
    driver.cuGraphDebugDotPrint.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint]
    driver.cuGraphDebugDotPrint.restype = ctypes.c_int
    with tempfile.TemporaryDirectory(prefix="some_tpu_torch_graph_") as tmp:
        dot = pathlib.Path(tmp) / "graph.dot"
        err = driver.cuGraphDebugDotPrint(kept.graph.raw_cuda_graph(), str(dot).encode(), 1)
        if err != 0:
            raise RuntimeError(f"cuGraphDebugDotPrint: CUDA driver error {err}")
        text = dot.read_text()
    counts = {}
    # a kernel node's label ends "| <mangled name>\<\<\<{grid},block,smem\>\>\>}"
    for line in text.splitlines():
        if LAUNCH in line:
            name = line.split(LAUNCH)[0].rsplit("|", 1)[-1].strip()
            counts[name] = counts.get(name, 0) + 1
    return counts


def dispatch_check(torch, graph, eager, chunks, per_forward: dict, label: str) -> dict:
    """The graph path against the eager path on every bucket group of
    ``chunks``: probs and bounds bit for bit, note counts, durations and
    rests exactly, note_midi to f32 rounding (the decode's float index_add_
    is atomic on CUDA). Then, for each group, its graph's kernel nodes
    (``graph_kernel_nodes``) hold exactly ``per_forward`` hand-written
    kernels and no other: one for each module that has a kernel, so none
    ran its plain version; and one profiled replay (``profiled_replay``)
    runs those, its kernels beside one eager forward's (``kernel_diff``)."""
    groups, _ = graph.bucket_groups(chunks)
    worst_midi = 0.0
    for _, audio, mask in groups:
        got = graph.run_bucket_staged(*graph.stage_inputs(audio, mask), frames=True)
        want = eager.run_bucket_staged(*eager.stage_inputs(audio, mask), frames=True)
        for key in ("probs", "bounds", "n_notes", "note_dur", "note_rest"):
            if not torch.equal(got[key], want[key]):
                raise AssertionError(f"{label}: graph vs eager {key} differ at bucket "
                                     f"{tuple(mask.shape)}: max |d| "
                                     f"{float((got[key].float() - want[key].float()).abs().max())}")
        worst_midi = max(worst_midi, float((got["note_midi"] - want["note_midi"]).abs().max()))
    if worst_midi > 1e-3:
        raise AssertionError(f"{label}: graph vs eager note_midi differ by {worst_midi}")
    kernels = []
    for _, audio, mask in groups:
        nodes = graph_kernel_nodes(torch, graph, audio, mask)
        if hand_written(nodes) != per_forward:
            raise AssertionError(f"{label}: the graph of bucket {tuple(mask.shape)} holds "
                                 f"hand-written kernels {hand_written(nodes)}, want {per_forward}")
        replay, sessions = profiled_replay(torch, graph, graph.stage_inputs(audio, mask),
                                           per_forward)
        if hand_written(replay) != per_forward:
            raise AssertionError(f"{label}: a profiled replay of bucket {tuple(mask.shape)} ran "
                                 f"hand-written kernels {hand_written(replay)} in {sessions} "
                                 f"sessions, want {per_forward}")
        staged_eager = eager.stage_inputs(audio, mask)
        forward = kernel_names(torch, lambda: eager.run_bucket_staged(*staged_eager))
        kernels.append({"shape": list(mask.shape), "graph_kernel_nodes": sum(nodes.values()),
                        "replay": sum(replay.values()), "profile_sessions": sessions,
                        "forward": sum(forward.values()), "hand_written": hand_written(replay),
                        "replay_vs_forward": kernel_diff(replay, forward)})
    return {"groups": len(groups), "max_note_midi_diff": worst_midi,
            "replay_vs_forward": kernels}


def timed_prewarm(torch, engine, buckets, rows=(1, 2, 3, 4, 6, 8)):
    """``engine.prewarm(buckets, rows)`` from an emptied allocator cache:
    (programs, seconds, GiB reserved after it, GiB still reserved once
    ``empty_cache`` has released the cached blocks outside the graphs'
    pool, such as the warm-ups')."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    n = engine.prewarm(buckets, rows=rows)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    grown = (torch.cuda.memory_reserved() - reserved) / 2 ** 30
    torch.cuda.empty_cache()
    held = (torch.cuda.memory_reserved() - reserved) / 2 ** 30
    if engine.graphs_captured != n:
        raise AssertionError(f"prewarm counted {n} programs, captured "
                             f"{engine.graphs_captured} graphs")
    return n, seconds, grown, held


def full_prewarm(torch, model, max_frames: int = 4096) -> dict:
    """A fresh engine's prewarm of every frame bucket up to ``max_frames`` at
    rows 1-8 (the row buckets 1, 2, 3, 4, 6, 8): 66 graphs in one memory
    pool, their seconds and the memory they hold."""
    from some_tpu_torch.infer import load_engine
    from some_tpu_torch.inference.base_infer import DEFAULT_BUCKETS

    engine = load_engine(model, device="cuda", quiet=True)
    buckets = [b for b in DEFAULT_BUCKETS if b <= max_frames]
    n, seconds, grown, held = timed_prewarm(torch, engine, buckets, rows=range(1, 9))
    log(f"prewarm of buckets {buckets} x rows 1-8: {n} graphs in {seconds:.2f} s, "
        f"{grown:.2f} GiB reserved ({held:.2f} GiB after empty_cache)")
    del engine
    torch.cuda.empty_cache()
    return {"buckets": buckets, "graphs": n, "prewarm_s": seconds, "reserved_gib": grown,
            "held_gib": held}


# Python run on the cold process's engine after its load: the dispatches
# that the cold CLI run is timed under
COLD_DISPATCH = {
    "graph": "",  # the default: a bucket's second run captures its graph
    "eager": "from some_tpu_torch.inference.base_infer import set_dispatch\n"
             "set_dispatch(engine, 'eager')",
    "first_use": "engine.CAPTURE_ON_VISIT = 1",  # capture at a bucket's first run
}


def cold_cli(torch, model, wav, workdir: pathlib.Path, reps: int = 2) -> dict:
    """The infer CLI's own case: a fresh process's ``load_engine`` +
    ``transcribe_file`` of one WAV (``bench.cold_file``, timed inside the
    process), under each of COLD_DISPATCH, ``reps`` times each in turns."""
    from some_tpu_torch.audio.wavio import load_wav
    from some_tpu_torch.bench import cold_file

    audio_s = len(load_wav(wav, sr=SR)[0]) / SR
    torch.cuda.empty_cache()
    order = list(COLD_DISPATCH) + list(COLD_DISPATCH)[::-1]
    runs = {mode: [] for mode in COLD_DISPATCH}
    for i in range(reps):
        for mode in order[:len(COLD_DISPATCH)] if i % 2 == 0 else order[len(COLD_DISPATCH):]:
            run = cold_file(model, wav, workdir / f"cold-{mode}-{i}.mid", device="cuda",
                            prelude=COLD_DISPATCH[mode])
            runs[mode].append(dict(run, rtf=audio_s / run["file_s"]))
    log(f"cold CLI ({audio_s:.2f} s of audio, a fresh process each): " + "; ".join(
        f"{mode} file s {[round(r['file_s'], 3) for r in rs]} (load s "
        f"{[round(r['load_s'], 2) for r in rs]}, {rs[0]['forwards']} forwards, "
        f"{rs[0]['graphs']} graphs)" for mode, rs in runs.items()))
    if any(r["graphs"] for r in runs["eager"]) or any(
            r["graphs"] != r["forwards"] for r in runs["first_use"]):
        raise AssertionError(f"cold CLI: a dispatch did not hold: {runs}")
    return {"audio_s": audio_s, "runs": runs}


def main_path(torch, workdir: pathlib.Path, setup: dict, opt_in: bool = False,
              quantize: bool = False, precisions=("bf16", "32-true")):
    """The infer CLI's path (``load_engine`` + ``transcribe_file``) in each of
    ``precisions`` (bf16 and 32-true), three ways:

    * graph, the default dispatch and the main path: from counts at 0, a
      fresh engine's ``prewarm`` of the songs' buckets (its time, graphs and
      the memory they reserve) and a first pass, which captures nothing
      more; launches = 2 x per forward x graphs (each capture's warm-up and
      the capture itself: a replay calls no wrapper);
    * eager (the test-only ``set_dispatch``): launches = per forward x
      forwards;
    * plain (the test-only ``impl`` switches at 'plain', eager).

    Then: warm passes of graph and eager in turns (g e e g g e) with a
    profiled pass of each (device ms, busy share); ``dispatch_check`` (graph
    vs eager bit for bit, kernels of a replay); note F1 graph vs plain (1.0
    in f32, >= 0.95 in bf16). ``opt_in`` adds ``fuse_ffn: true`` and
    ``attention_impl: splash``. ``quantize`` adds ``quantize: int8``: the
    engine quantizes the weights as it loads them, its graphs hold no K3
    (a quantized model never fuses its FFNs) and the plain path runs the same
    int8 products, so graph vs plain note F1 is held to >= 0.95 in f32 too
    (an ulp between a kernel and its plain version at a .5 code boundary
    rounds a code to its neighbour); the notes are also held against the
    unquantized run of
    the same configuration and precision (its MIDI files, which must exist),
    and the resident weight bytes are recorded."""
    from some_tpu_torch.config import save_yaml
    from some_tpu_torch.infer import load_engine, transcribe_file
    from some_tpu_torch.inference.base_infer import set_dispatch
    from some_tpu_torch.nn.conformer import set_kernel_impl
    from some_tpu_torch.utils.midi_file import MidiFile, midi_notes_to_arrays
    from some_tpu_torch.utils.note_f1 import note_f1

    base_tag = "opt-in" if opt_in else "default"
    tag = base_tag + ("-int8" if quantize else "")
    blocks, wavs, audio_s = setup["blocks"], setup["wavs"], setup["audio_s"]
    per_forward = ({"depthwise_conv1d": blocks, "fused_ln_ffn_residual": 2 * blocks,
                    "splash_attention": blocks} if opt_in else
                   {"depthwise_conv1d": blocks, "flash_attention": blocks})
    if quantize:
        per_forward.pop("fused_ln_ffn_residual", None)
    dirs = {}
    for precision in precisions:
        d = workdir / f"{tag}-{precision}"
        d.mkdir()
        save_yaml(dict(setup["config"], pl_trainer_precision=precision,
                       **(OPT_IN if opt_in else {}), **({"quantize": "int8"} if quantize else {})),
                  d / "config.yaml")
        os.symlink(setup["ckpt"], d / "model.pt")
        dirs[precision] = d / "model.pt"

    def run_pass(engine, name):
        t0 = time.perf_counter()
        paths = [transcribe_file(engine, wav, workdir / f"{tag}-{name}-{i}.mid")
                 for i, wav in enumerate(wavs)]
        torch.cuda.synchronize()
        return paths, time.perf_counter() - t0

    def check_launches(label, launched, want):
        want = {name: want.get(name, 0) for name in launched}
        if launched != want:
            raise AssertionError(f"{tag} {label}: launches {launched}, want {want}")

    def f1s(ref, got):
        return [note_f1(midi_notes_to_arrays(MidiFile.load(a)),
                        midi_notes_to_arrays(MidiFile.load(b)),
                        onset_tolerance=0.05, pitch_tolerance=0.5).f1 for a, b in zip(ref, got)]

    result, launches = {}, {}
    for precision in precisions:
        # the main path: graphs, from counts at 0 through prewarm and a first pass
        reset_counts()
        graph = load_engine(dirs[precision], device="cuda", quiet=True)
        if graph.model.quant != ("int8" if quantize else "none"):
            raise AssertionError(f"{tag} {precision}: the engine's model is {graph.model.quant}")
        n_prewarm, prewarm_s, graph_gib, graph_held_gib = timed_prewarm(
            torch, graph, setup["buckets"])
        if graph.graphs_captured != n_prewarm:
            raise AssertionError(f"{tag} {precision}: prewarm counted {n_prewarm} programs, "
                                 f"captured {graph.graphs_captured} graphs")
        torch.cuda.reset_peak_memory_stats()
        midis, first_s = run_pass(graph, f"{precision}-graph")
        if graph.graphs_captured != n_prewarm:
            raise AssertionError(f"{tag} {precision}: traffic captured "
                                 f"{graph.graphs_captured - n_prewarm} graphs after prewarm")
        graph_launched = read_counts()
        check_launches(f"{precision} graph path", graph_launched,
                       {n: 2 * c * n_prewarm for n, c in per_forward.items()})
        notes = [len(MidiFile.load(m).notes()) for m in midis]
        if min(notes) == 0:
            raise AssertionError(f"{tag} {precision}: a MIDI file with no notes: {notes}")
        log(f"{tag} {precision} graph path: prewarm {n_prewarm} graphs of buckets "
            f"{setup['buckets']} in {prewarm_s:.2f} s, {graph_gib:.2f} GiB reserved "
            f"({graph_held_gib:.2f} GiB after empty_cache); first "
            f"pass {graph.forwards - n_prewarm} replays, launches "
            f"{ {n: c for n, c in graph_launched.items() if c} } (captures only)")

        reset_counts()
        eager = load_engine(dirs[precision], device="cuda", quiet=True)
        set_dispatch(eager, "eager")
        eager_midis, eager_first_s = run_pass(eager, f"{precision}-eager")
        eager_launched = read_counts()
        if eager.forwards == 0:
            raise AssertionError(f"{tag} {precision}: the eager pass ran no forward")
        check_launches(f"{precision} eager path", eager_launched,
                       {n: c * eager.forwards for n, c in per_forward.items()})
        log(f"{tag} {precision} eager path: {eager.forwards} forwards, launches "
            f"{ {n: c for n, c in eager_launched.items() if c} }")

        warm = {"graph": [], "eager": []}
        for name in ("graph", "eager", "eager", "graph", "graph", "eager"):
            engine = graph if name == "graph" else eager
            warm[name].append(run_pass(engine, f"{precision}-{name}-warm")[1])
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        profiles = {}
        for name, engine in (("graph", graph), ("eager", eager)):
            prof = profile_pass(torch, lambda: run_pass(engine, f"{precision}-{name}-prof"))
            prof["busy_share_of_warm_wall"] = (prof["device_ms"] / 1e3
                                               / statistics.median(warm[name]))
            profiles[name] = prof
            log(f"{tag} {precision} {name} profile: " + json.dumps(prof))
        dispatch = dispatch_check(torch, graph, eager, setup["chunks"], per_forward,
                                  f"{tag} {precision}")
        log(f"{tag} {precision} graph vs eager: " + json.dumps(dispatch))
        graph_vs_eager_f1 = f1s(eager_midis, midis)
        weight_bytes = graph.weight_bytes
        del graph, eager
        torch.cuda.empty_cache()

        plain = load_engine(dirs[precision], device="cuda", quiet=True)
        set_kernel_impl(plain.model, "plain")
        set_dispatch(plain, "eager")
        reset_counts()
        plain_midis, plain_first_s = run_pass(plain, f"{precision}-plain")
        plain_warm = [run_pass(plain, f"{precision}-plain-warm")[1] for _ in range(3)]
        if any(read_counts().values()):
            raise AssertionError(f"the plain path launched kernels: {read_counts()}")
        del plain
        torch.cuda.empty_cache()

        f1 = f1s(plain_midis, midis)
        # int8: the kernels and their plain versions agree to f32 rounding,
        # and a value an ulp apart at a .5 code boundary rounds to the
        # neighbouring code, so int8 notes move in f32 as bf16 ones do
        need = 1.0 if precision == "32-true" and not quantize else 0.95
        warm["plain"] = plain_warm
        rtf = {name: audio_s / statistics.median(times) for name, times in warm.items()}
        log(f"{tag} {precision}: notes per song {notes}; graph-vs-plain note F1 {f1} (need >= "
            f"{need}), graph-vs-eager {graph_vs_eager_f1}; RTF first graph "
            f"{audio_s / first_s:.2f}x (after prewarm) / eager {audio_s / eager_first_s:.2f}x, "
            f"warm median graph {rtf['graph']:.2f}x / eager {rtf['eager']:.2f}x / plain "
            f"{rtf['plain']:.2f}x; device ms "
            f"graph {profiles['graph']['device_ms']:.1f} / eager "
            f"{profiles['eager']['device_ms']:.1f}; busy graph "
            f"{profiles['graph']['busy_share_of_warm_wall']:.3f} / eager "
            f"{profiles['eager']['busy_share_of_warm_wall']:.3f} of the warm median wall; "
            f"peak {peak_gb:.2f} GiB")
        if min(f1) < need:
            raise AssertionError(f"{tag} {precision}: graph-vs-plain note F1 {f1} below {need}")
        extra = {"weight_bytes": weight_bytes}
        if quantize:
            unquantized = [workdir / f"{base_tag}-{precision}-graph-{i}.mid"
                           for i in range(len(wavs))]
            extra["f1_vs_unquantized"] = f1s(unquantized, midis)
            log(f"{tag} {precision}: note F1 against the unquantized engine "
                f"{extra['f1_vs_unquantized']}; resident weights {weight_bytes} bytes")
        result[precision] = {**extra,
            "notes": notes, "f1_vs_plain": f1, "f1_graph_vs_eager": graph_vs_eager_f1,
            "audio_s": audio_s, "prewarm_graphs": n_prewarm, "prewarm_s": prewarm_s,
            "graph_reserved_gib": graph_gib, "graph_held_gib": graph_held_gib,
            "first_s": first_s, "eager_first_s": eager_first_s,
            "plain_first_s": plain_first_s, "warm_s": warm,
            "rtf_warm_median": rtf, "graph_launches": graph_launched,
            "eager_launches": eager_launched, "peak_gib": peak_gb, "profile": profiles,
            "dispatch_check": dispatch}
        launches.setdefault("graph", graph_launched)
        launches.setdefault("eager", eager_launched)
    return result, launches


# ---- launch counts; the training slice ----

def kernel_counters():
    """name -> the wrapper whose ``launches`` counts that kernel's launches."""
    from some_tpu_torch.ops import attention as A
    from some_tpu_torch.ops import depthwise as W
    from some_tpu_torch.ops import fused_ffn as K3

    return {"depthwise_conv1d": W.depthwise_conv1d, "depthwise_conv1d_dx": W.depthwise_conv1d_dx,
            "depthwise_conv1d_dw": W.depthwise_conv1d_dw, "flash_attention": A.flash_attention,
            "flash_attention_fwd_res": A.flash_attention_fwd_res,
            "flash_attention_bwd_dkv": A.flash_attention_bwd_dkv,
            "flash_attention_bwd_dq": A.flash_attention_bwd_dq,
            "fused_ln_ffn_residual": K3.fused_ln_ffn_residual,
            "splash_attention": A.splash_attention,
            "splash_attention_fwd_res": A.splash_attention_fwd_res,
            "splash_attention_bwd_dkv": A.splash_attention_bwd_dkv,
            "splash_attention_bwd_dq": A.splash_attention_bwd_dq}


def read_counts():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def tol_ratio(torch, got, want, rel, extra=None):
    """max |got - want| / (grad_tolerance(want, rel) + extra), with the ulp of
    got's dtype; ``extra`` (broadcast against want) defaults to 0."""
    d = (got.detach().float() - want.detach().float()).abs()
    tol = grad_tolerance(torch, want, rel, got.dtype)
    return float((d / (tol if extra is None else tol + extra)).max())


def compare(torch, label, got, want, rel, extra=None):
    """Raise unless ``got`` is finite and within grad_tolerance(want, rel)
    (+ ``extra``) everywhere; returns (max |d|, max |d| / tol)."""
    ratio = tol_ratio(torch, got, want, rel, extra)
    finite = bool(torch.isfinite(got.detach().float()).all())
    if not finite or ratio > 1.0:
        raise AssertionError(f"{label}: max |d|/tol {ratio:.3f}, finite {finite}")
    return float((got.detach().float() - want.detach().float()).abs().max()), ratio


def timing_row(torch, shape, dtype, max_diff, ratio, kernel, plain, library, nbytes, flops,
               peak, reps=10):
    bound_ms, bound_by = bound(nbytes, flops, peak)
    return {"shape": list(shape), "dtype": str(dtype)[6:], "max_abs_diff": max_diff,
            "max_diff_over_tol": ratio, "kernel_ms": median_ms(torch, kernel, reps=reps),
            "plain_ms": median_ms(torch, plain, reps=3, warmup=1),
            "library_ms": median_ms(torch, library, reps=reps),
            "bound_ms": bound_ms, "bound_by": bound_by}


def check_depthwise_backward(torch, sm_clock_mhz):
    """K1's backward: dx (the forward kernel on the cotangent with the taps
    in reverse order) and dw (the reduction kernels) against the autograd of
    the plain version, on a random cotangent. Tolerance: 2 ulp of |want| in
    its dtype plus 1e-4 x RMS(want) (f32 sums over B*T in another order);
    dx also bit for bit against the plain version on w.flip(0), dw the same
    bits on a second run."""
    from some_tpu_torch.ops.depthwise import (
        depthwise_conv1d, depthwise_conv1d_dw, depthwise_conv1d_dw_plain, depthwise_conv1d_dx,
        depthwise_conv1d_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {"depthwise_conv1d_dx": [], "depthwise_conv1d_dw": []}
    K = 31
    for shape in DEPTHWISE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            B, T, C = shape
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype).requires_grad_()
            w = (torch.randn((K, C), generator=gen, device="cuda") * 0.1).to(dtype)
            w.requires_grad_()
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            y = depthwise_conv1d(x, w)
            if y.grad_fn is None:
                raise AssertionError("K1 on a CUDA tensor that needs grad returned no grad_fn")
            dx, dw = torch.autograd.grad(y, (x, w), g)
            want_dx, want_dw = torch.autograd.grad(depthwise_conv1d_plain(x, w), (x, w), g)
            xd, wd = x.detach(), w.detach()
            xc, gc = xd.transpose(1, 2).contiguous(), g.transpose(1, 2).contiguous()
            wc = wd.t().unsqueeze(1).contiguous()
            nbytes = (2 * B * T * C + K * C) * x.element_size()
            for name, got, want, kernel, plain, library in (
                    ("depthwise_conv1d_dx", dx, want_dx, lambda: depthwise_conv1d_dx(g, wd),
                     lambda: depthwise_conv1d_plain(g, wd.flip(0)),
                     lambda: torch.nn.grad.conv1d_input(xc.shape, wc, gc, padding=K // 2,
                                                        groups=C)),
                    ("depthwise_conv1d_dw", dw, want_dw, lambda: depthwise_conv1d_dw(xd, g, K),
                     lambda: depthwise_conv1d_dw_plain(xd, g, K),
                     lambda: torch.nn.grad.conv1d_weight(xc, wc.shape, gc, padding=K // 2,
                                                         groups=C))):
                max_diff, ratio = compare(torch, f"{name} {list(shape)} {dtype}", got, want, 1e-4)
                log(f"{name} {list(shape)} {str(dtype)[6:]}: max|d| {max_diff:.3e}, max |d|/tol "
                    f"{ratio:.3f} (2 ulp + 1e-4 RMS): ok")
                if name == "depthwise_conv1d_dx":
                    # bit for bit with the plain version on the reversed taps
                    want_flip = depthwise_conv1d_plain(g, wd.flip(0))
                    if not torch.equal(kernel(), want_flip):
                        raise AssertionError(f"K1 dx differs from the plain version on "
                                             f"w.flip(0) at {shape} {dtype}")
                else:
                    # no atomics: a second run gives the same bits
                    if not torch.equal(kernel(), dw):
                        raise AssertionError(f"K1 dw changed bits between runs at {shape} {dtype}")
                row = timing_row(torch, shape, dtype, max_diff, ratio, kernel, plain, library,
                                 nbytes, 2 * B * T * C * K, PEAK_FLOPS["float32"])
                row["device_ms"] = device_ms(torch, kernel)
                row["host_ms"] = host_ms(torch, kernel)
                row["library_device_ms"] = device_ms(torch, library)
                if name == "depthwise_conv1d_dx":
                    row["fp32_floor_ms"] = fp32_floor_ms(torch, B, T, C, K, sm_clock_mhz)
                    log(f"{name} {list(shape)} {str(dtype)[6:]}: bytes bound "
                        f"{row['bound_ms']:.4f} ms, FP32-instruction floor "
                        f"{row['fp32_floor_ms']:.4f} ms")
                rows[name].append(row)
            del x, w, g, y, dx, dw, want_dx, want_dw, xd, wd, xc, gc, wc
            torch.cuda.empty_cache()
    return rows


# K2's bf16 results held against the plain bf16 autograd as well as against
# the f32 gradient: all but dk, where that autograd itself misses the f32
# gradient's bound (it rounds dP = dO V^T to bf16 before dS = P (dP - delta)
# cancels; the kernels keep dP in f32, as JAX's kernel does; PERF.md)
BF16_PLAIN_HELD = ("out", "dq", "dv")


def check_attention_backward(torch):
    """K2 for training: the forward with residuals and the dk/dv and dq
    kernels, through FlashAttentionFn, with q, k, v, dO as [B, H, T, D] views
    of [B, T, H, D] storage (as the model passes them), a padded tail, an
    all-masked row (B > 1) and a random dO. Tolerance: 2 ulp of |want| plus
    0.02 x RMS(want) in bf16, 5e-5 x RMS(want) in f32. In f32 the reference
    is the autograd of the plain version. In bf16 out, dq, dk and dv are held
    against the f32 gradient of the same bf16 inputs (the plain autograd on
    q, k, v, dO cast to f32), and all but dk against the plain bf16 autograd
    too (BF16_PLAIN_HELD). dk's |d|/tol against it, and the plain bf16
    autograd's own against the f32 gradient, are logged beside. The last
    shape's draw is the one on which dq once missed the f32 bound (the
    caller's delta from the bf16 output; csrc/flash_attention_bwd.cu). In the
    all-masked row dq and dk must be exactly 0, and so must dk at padded
    keys."""
    import torch.nn.functional as F
    from some_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = {"flash_attention_fwd_res": [], "flash_attention_bwd_dkv": [],
            "flash_attention_bwd_dq": []}
    for shape in ((8, 8, 1024, 64), (8, 8, 2048, 64), (1, 8, 8192, 64), (2, 2, 77, 32),
                  (3, 2, 77, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            B, H, T, D = shape
            q, k, v, do = (torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype)
                           .transpose(1, 2) for _ in range(4))
            mask = torch.ones((B, T), dtype=torch.bool, device="cuda")
            tail = int(T * 0.7)
            mask[0, tail:] = False
            if B > 1:
                mask[B - 1] = False
            scale = D ** -0.5
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = A.flash_attention(*leaves, mask, scale)
            if out.grad_fn is None:
                raise AssertionError("K2 on a CUDA tensor that needs grad returned no grad_fn")
            grads = torch.autograd.grad(out, leaves, do)
            want_out = A.attention_plain(*leaves, mask, scale)
            wants = torch.autograd.grad(want_out, leaves, do, retain_graph=True)
            rel = 0.02 if dtype == torch.bfloat16 else 5e-5
            label = f"{list(shape)} {str(dtype)[6:]}"
            names = ("out", "dq", "dk", "dv")
            got_all, plain_all = (out, *grads), (want_out, *wants)
            if dtype == torch.bfloat16:
                leaves32 = [t.detach().float().requires_grad_() for t in (q, k, v)]
                want32 = A.attention_plain(*leaves32, mask, scale)
                f32_all = (want32, *torch.autograd.grad(want32, leaves32, do.float()))
                del leaves32, want32
                vs_plain = {n: compare(torch, f"K2 {n} {label} vs plain", g, w, rel)[1]
                            if n in BF16_PLAIN_HELD else tol_ratio(torch, g, w, rel)
                            for n, g, w in zip(names, got_all, plain_all)}
                checks = {n: compare(torch, f"K2 {n} {label} vs f32", g, w, rel)
                          for n, g, w in zip(names, got_all, f32_all)}
                plain_vs_f32 = {n: tol_ratio(torch, w, w32, rel)
                                for n, w, w32 in zip(names, plain_all, f32_all)}
                text = ", ".join(f"{n} |d|/tol {checks[n][1]:.3f} vs f32, {vs_plain[n]:.3f} "
                                 f"vs plain bf16{'' if n in BF16_PLAIN_HELD else ' (not held)'}"
                                 for n in names)
                text += "; the plain bf16 autograd vs f32: " + ", ".join(
                    f"{n} {r:.3f}" for n, r in plain_vs_f32.items())
                del f32_all
            else:
                checks = {n: compare(torch, f"K2 {n} {label}", g, w, rel)
                          for n, g, w in zip(names, got_all, plain_all)}
                text = ", ".join(f"{n} max|d| {d:.3e} |d|/tol {r:.3f}"
                                 for n, (d, r) in checks.items())
            empty = ~mask.any(dim=1)
            exact = (bool((grads[1][0, :, tail:] == 0).all())
                     and bool((grads[0][empty] == 0).all()) and bool((grads[1][empty] == 0).all()))
            if not exact:
                raise AssertionError(f"K2 {label}: nonzero dq or dk at masked keys or rows")
            log(f"K2 backward {label}: {text} (2 ulp + {rel} RMS); dq, dk exactly 0 at masked "
                f"keys and in the {int(empty.sum())} all-masked row(s): ok")

            out_k, stats = A.flash_attention_fwd_res(q, k, v, mask, scale)
            delta = (do.float() * out_k.float()).sum(-1).contiguous()
            sdpa_mask = (mask | empty[:, None])[:, None, None, :]
            lib_leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(*lib_leaves, attn_mask=sdpa_mask)
            isz = q.element_size()
            peak = PEAK_FLOPS[str(dtype)[6:]]
            flops = H * D * key_pairs(mask)
            plain_bwd = lambda: torch.autograd.grad(want_out, leaves, do, retain_graph=True)
            lib_bwd = lambda: torch.autograd.grad(lib_out, lib_leaves, do, retain_graph=True)

            def lib_fwd():
                with torch.enable_grad():
                    return F.scaled_dot_product_attention(*lib_leaves, attn_mask=sdpa_mask)

            d_out = checks["out"]
            d_kv = max(checks["dk"], checks["dv"])
            rows["flash_attention_fwd_res"].append(timing_row(
                torch, shape, dtype, *d_out, lambda: A.flash_attention_fwd_res(q, k, v, mask, scale),
                lambda: A.attention_plain(q, k, v, mask, scale), lib_fwd,
                4 * B * H * T * D * isz + B * T + 8 * B * H * T, 4 * flops, peak, reps=5))
            rows["flash_attention_bwd_dkv"].append(timing_row(
                torch, shape, dtype, *d_kv,
                lambda: A.flash_attention_bwd_dkv(q, k, v, do, stats, delta, mask, scale),
                plain_bwd, lib_bwd, 6 * B * H * T * D * isz + 12 * B * H * T + B * T,
                8 * flops, peak, reps=5))
            dq_k, _ = A.flash_attention_bwd_dq(q, k, v, do, stats, delta, mask, scale)
            dq_p, _ = A.flash_attention_bwd_dq_plain(q, k, v, do, stats, delta, mask, scale)
            rel_own = 0.002 if dtype == torch.bfloat16 else 2e-5
            own = compare(torch, f"K2 dq kernel {label} vs its plain version", dq_k, dq_p,
                          rel_own)[1]
            log(f"  K2 dq kernel {label} vs flash_attention_bwd_dq_plain: |d|/tol {own:.3f} "
                f"(2 ulp + {rel_own} RMS): ok")
            del dq_k, dq_p
            rows["flash_attention_bwd_dq"].append(timing_row(
                torch, shape, dtype, *checks["dq"],
                lambda: A.flash_attention_bwd_dq(q, k, v, do, stats, delta, mask, scale),
                plain_bwd, lib_bwd, 5 * B * H * T * D * isz + 16 * B * H * T + B * T,
                6 * flops, peak, reps=5))
            del q, k, v, do, leaves, out, grads, want_out, wants, out_k, stats, delta
            del lib_leaves, lib_out, plain_bwd, lib_bwd
            torch.cuda.empty_cache()
    return rows


# ---- the opt-in kernels: K3 (fused FFN) and K4 (splash attention) ----

def fused_ffn_tolerance(torch, want):
    """Allowed |kernel - plain| for each element of ``want``. f32: 2e-5 +
    1e-5 |want| (sums of 512 and 2048 products in another order). bf16: both
    round the output once (2 ulp of |want|), and a hidden value whose f32 sum
    lands on the other side of a bf16 rounding moves the output by about an
    ulp of that value times its W2 weights: 0.01 x RMS(want)."""
    if want.dtype == torch.float32:
        return 2e-5 + 1e-5 * want.abs()
    w = want.float()
    return 2 * bf16_ulp(torch, w) + 0.01 * float(w.pow(2).mean().sqrt())


def check_fused_ffn(torch):
    """K3 against its plain version at the inference shapes, with the time of
    the unfused eager chain it replaces (LayerNorm, Linear, SiLU, Linear,
    residual: five PyTorch calls; cuBLAS, no TF32) as ``eager_chain_ms``. No
    single PyTorch call computes K3's function, so its ``library_ms`` is
    None. The weights are f32 [D, H] and [H, D] views of [out, in] storage,
    as the model passes its Linear weights; the kernel, its plain version and
    the chain are timed on the same weights in x's dtype, so none of the
    three times a cast of the weights."""
    import torch.nn.functional as F
    from some_tpu_torch.ops.fused_ffn import fused_ln_ffn_residual, fused_ln_ffn_residual_plain

    gen = torch.Generator(device="cuda").manual_seed(5)
    D, H = 512, 2048
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    weights = [1.0 + 0.1 * randn(D), 0.1 * randn(D), (randn(H, D) * D ** -0.5).t(),
               0.1 * randn(H), (randn(D, H) * H ** -0.5).t(), 0.1 * randn(D)]
    g, b, w1, b1, w2, b2 = weights
    rows = []
    for shape in ((8, 1024, D), (1, 6144, D), (3, 77, D)):
        for dtype in (torch.bfloat16, torch.float32):
            x = randn(*shape).to(dtype)
            got = fused_ln_ffn_residual(x, *weights)
            want = fused_ln_ffn_residual_plain(x, *weights)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            ratio = float((d / fused_ffn_tolerance(torch, want)).max())
            finite = bool(torch.isfinite(got.float()).all())
            tol_text = ("|d| <= 2e-5 + 1e-5 |want|" if dtype == torch.float32 else
                        "|d| <= 2 bf16 ulp + 0.01 RMS")
            log(f"K3 fused FFN {list(shape)} {str(dtype)[6:]}: max|d| {float(d.max()):.3e}, "
                f"max |d|/tol {ratio:.3f} ({tol_text}); finite {finite}: "
                f"{'ok' if ratio <= 1 and finite else 'FAIL'}")
            if ratio > 1 or not finite:
                raise AssertionError(f"K3 disagrees with its plain version at {shape} {dtype}: "
                                     f"max |d|/tol {ratio}, finite {finite}")
            gd, bd, b1d, b2d = (t.to(dtype) for t in (g, b, b1, b2))
            w1l, w2l = w1.t().to(dtype), w2.t().to(dtype)  # [out, in], contiguous
            timed = [g, b, w1l.t(), b1, w2l.t(), b2]

            def chain():
                h = F.linear(F.layer_norm(x, (D,), gd, bd, 1e-5), w1l, b1d)
                return F.linear(F.silu(h), w2l, b2d) * 0.5 + x

            n = shape[0] * shape[1]
            isz = x.element_size()
            row = timing_row(torch, shape, dtype, float(d.max()), ratio,
                             lambda: fused_ln_ffn_residual(x, *timed),
                             lambda: fused_ln_ffn_residual_plain(x, *timed), chain,
                             2 * n * D * isz + 2 * D * H * isz + (3 * D + H) * 4,
                             4 * n * D * H, PEAK_FLOPS[str(dtype)[6:]])
            row["eager_chain_ms"], row["library_ms"] = row["library_ms"], None
            # 36 calls in a row, as a forward makes them
            row["kernel_ms_back_to_back"] = back_to_back_ms(
                torch, lambda: fused_ln_ffn_residual(x, *timed))
            row["eager_chain_ms_back_to_back"] = back_to_back_ms(torch, chain)
            log(f"  K3 {list(shape)} {str(dtype)[6:]}: kernel {row['kernel_ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, unfused eager chain {row['eager_chain_ms']:.4f} ms, "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); 36 calls in a row: kernel "
                f"{row['kernel_ms_back_to_back']:.4f} ms, chain "
                f"{row['eager_chain_ms_back_to_back']:.4f} ms a call")
            rows.append(row)
            del x, got, want, d
    torch.cuda.empty_cache()
    return rows


def splash_inputs(torch, gen, shape, dtype):
    """q, k, v, dO as [B, H, T, D] views of [B, T, H, D] storage (as the
    model passes them), and a mask with a padded tail in row 0 and, for
    B > 1, an all-padding last row."""
    B, H, T, D = shape
    q, k, v, do = (torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype)
                   .transpose(1, 2) for _ in range(4))
    mask = torch.ones((B, T), dtype=torch.bool, device="cuda")
    mask[0, int(T * 0.7):] = False
    if B > 1:
        mask[B - 1] = False
    return q, k, v, do, mask


def segment_pairs(mask):
    """The (query, key) pairs of one head that share a segment: the work the
    segment ids leave."""
    real = mask.sum(dim=1).double()
    return int((real ** 2 + (mask.shape[1] - real) ** 2).sum())


def segment_mask(mask):
    """[B, 1, T, T] bool: query and key in one segment, for SDPA."""
    return (mask[:, :, None] == mask[:, None, :])[:, None]


def splash_forward_tolerance(torch, want):
    """f32: 1e-5. bf16: both round the output to bf16 once (an ulp apart at
    worst) and sum P.V in another order: 2 bf16 ulp of |want| + 0.005 RMS."""
    if want.dtype == torch.float32:
        return torch.full_like(want, 1e-5, dtype=torch.float32)
    w = want.float()
    return 2 * bf16_ulp(torch, w) + 0.005 * float(w.pow(2).mean().sqrt())


def check_splash(torch):
    """K4's forward, inference and with log-sum-exp, against the plain
    version (splash's reference) on every row: padded queries attend only
    padded keys, the all-padding row attends all its keys. The two kernels
    are one template and must agree bit for bit; lse within 1e-5 relative of
    the plain f32 log-sum-exp."""
    import torch.nn.functional as F
    from some_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for shape in ((8, 8, 1024, 64), (8, 8, 2048, 64), (1, 8, 8192, 64), (2, 2, 77, 32)):
        for dtype in (torch.bfloat16, torch.float32):
            B, H, T, D = shape
            q, k, v, _, mask = splash_inputs(torch, gen, shape, dtype)
            scale = D ** -0.5
            qs = A.prescale(q, scale)
            got = A.splash_attention(q, k, v, mask, scale)
            got_res, lse, _ = A.splash_attention_fwd_res(qs, k, v, mask)
            want = A.splash_attention_plain(q, k, v, mask, scale)
            scores = torch.matmul(qs.float(), k.float().transpose(-1, -2)).masked_fill(
                ~segment_mask(mask), A.SPLASH_MASK_VALUE)
            want_lse = torch.logsumexp(scores, dim=-1)
            del scores
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            ratio = float((d / splash_forward_tolerance(torch, want)).max())
            lse_ratio = float(((lse - want_lse).abs() / (1e-5 * want_lse.abs().clamp(min=1.0)))
                              .max())
            same = torch.equal(got, got_res)
            finite = bool(torch.isfinite(got.float()).all())
            ok = ratio <= 1 and lse_ratio <= 1 and same and finite
            log(f"K4 splash {list(shape)} {str(dtype)[6:]}: max|d| {float(d.max()):.3e}, max "
                f"|d|/tol {ratio:.3f} (f32 1e-5; bf16 2 ulp + 0.005 RMS), lse max |d|/tol "
                f"{lse_ratio:.3f} (1e-5 relative); with-lse output identical {same}; finite "
                f"{finite}: {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K4 forward disagrees with its plain version at {shape} "
                                     f"{dtype}: {ratio}, lse {lse_ratio}, same {same}")
            seg = segment_mask(mask)
            isz = q.element_size()
            row = timing_row(torch, shape, dtype, float(d.max()), ratio,
                             lambda: A.splash_attention(q, k, v, mask, scale),
                             lambda: A.splash_attention_plain(q, k, v, mask, scale),
                             lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=seg,
                                                                    scale=scale),
                             4 * B * H * T * D * isz + B * T,
                             4 * H * D * segment_pairs(mask), PEAK_FLOPS[str(dtype)[6:]])
            row["lse_max_diff_over_tol"] = lse_ratio
            log(f"  K4 fwd {list(shape)} {str(dtype)[6:]}: kernel {row['kernel_ms']:.4f} ms, "
                f"plain {row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
            rows.append(row)
            del q, k, v, qs, got, got_res, lse, want, want_lse, d, seg
            torch.cuda.empty_cache()
    return rows


def splash_f32_reference(torch, qs, k, v, do, mask):
    """The f32 reference of K4's bf16 backward: dqs (the gradient of the
    pre-scaled q), dk, dv of splash's function on f32 copies of the bf16
    inputs, with splash's roundings of P and dS to bf16 kept, the exact f32
    log-sum-exp and di = rowsum(P dP) in f32 (not from the bf16 output)."""
    from some_tpu_torch.ops import attention as A

    f = [t.float() for t in (qs, k, v, do)]
    s = torch.matmul(f[0], f[1].transpose(-1, -2)).masked_fill(~segment_mask(mask),
                                                               A.SPLASH_MASK_VALUE)
    lse = torch.logsumexp(s, dim=-1)
    del s
    p, dp = A._splash_p_dp(*f, lse, mask)
    di = (p * dp).sum(-1)
    del p, dp
    return (A.splash_attention_bwd_dq_plain(*f, lse, di, mask, torch.bfloat16),
            *A.splash_attention_bwd_dkv_plain(*f, lse, di, mask, torch.bfloat16))


def splash_flip_allowance(torch, qs, k, v, do, lse, di, mask):
    """What K4's bf16 dq, dk and dv may differ from splash_attention_bwd_dq_plain's
    and splash_attention_bwd_dkv_plain's on top of grad_tolerance. Kernel and
    plain version round P and dS = (dP - di) P to bf16 once, as splash does,
    from f32 values that differ in their last bits (exp on the
    special-function unit, sums in another order), and one term that lands on
    the other side of a bf16 rounding moves dq by a bf16 ulp of its dS times
    its k, dk by a bf16 ulp of its dS times its qs, and dv by a bf16 ulp of
    its P times its dO: more than 0.002 RMS where T is long and the terms are
    many and small (on an H100: dv 2.884 at [8, 8, 1024, 64], dk 2.2356 and,
    on the tensor cores, dq 2.2209 at (3, 2, 1000, 32)). Per element (query
    or key, column d): the largest such term over the keys of the query or
    the queries of the key, one flip.
    Returns (for dq, for dk, for dv)."""
    from some_tpu_torch.ops import attention as A

    def one_flip(x, y):
        """max over rows i of ulp_bf16(x[i, j]) * |y[i, d]|, in chunks of rows."""
        _, exponent = torch.frexp(x)
        ulp = torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), exponent - 8))
        del exponent
        B, H, T, D = y.shape
        y = y.float().abs()
        out = torch.zeros((B, H, T, D), device=y.device)
        step = max(1, 2 ** 28 // (B * H * T * D))
        for q0 in range(0, T, step):
            terms = ulp[:, :, q0:q0 + step, :, None] * y[:, :, q0:q0 + step, None, :]
            out = torch.maximum(out, terms.amax(dim=2))
            del terms
        return out

    p, dp = A._splash_p_dp(qs, k, v, do, lse, mask)
    dv = one_flip(p, do)
    ds = (dp - di[..., None]) * p
    del p, dp
    return one_flip(ds.transpose(-1, -2), k), one_flip(ds, qs), dv


def check_splash_backward(torch):
    """K4 for training through SplashAttentionFn against the plain
    version's autograd, with a random dO: chip_smoke's grad_tolerance with
    rel 5e-5 in f32 and 0.1 in bf16 (the kernels round P and dS to bf16 as
    splash's do, the plain autograd keeps them f32). Then with dO zero on the
    padded query rows: dq at padded queries and dk, dv at padded keys must
    be exactly 0 (no gradient crosses segments). Then the kernels one by
    one on di from the training forward's output and its residual
    (splash_di), as the backward runs them: dq against
    splash_attention_bwd_dq_plain and dk, dv against
    splash_attention_bwd_dkv_plain, 2 ulp + 0.002 RMS in bf16 and 2e-5 RMS
    in f32; in bf16 all three against splash_f32_reference, 2 ulp + 0.02
    RMS."""
    import torch.nn.functional as F
    from some_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = {"splash_attention_fwd_res": [], "splash_attention_bwd_dkv": [],
            "splash_attention_bwd_dq": []}
    for shape in ((8, 8, 1024, 64), (8, 8, 2048, 64), (1, 8, 8192, 64), (2, 2, 77, 32)):
        for dtype in (torch.bfloat16, torch.float32):
            B, H, T, D = shape
            q, k, v, do, mask = splash_inputs(torch, gen, shape, dtype)
            scale = D ** -0.5
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = A.splash_attention(*leaves, mask, scale)
            if out.grad_fn is None:
                raise AssertionError("K4 on a CUDA tensor that needs grad returned no grad_fn")
            grads = torch.autograd.grad(out, leaves, do)
            want_out = A.splash_attention_plain(*leaves, mask, scale)
            wants = torch.autograd.grad(want_out, leaves, do, retain_graph=True)
            rel = 0.1 if dtype == torch.bfloat16 else 5e-5
            label = f"{list(shape)} {str(dtype)[6:]}"
            checks = {name: compare(torch, f"K4 {name} {label}", got, want, rel)
                      for name, got, want in zip(("dq", "dk", "dv"), grads, wants)}
            pad = ~mask
            do0 = do * mask[:, None, :, None]
            zeroed = torch.autograd.grad(A.splash_attention(*leaves, mask, scale), leaves, do0)
            exact = all(bool((g.transpose(1, 2)[pad] == 0).all()) for g in zeroed)
            if not exact:
                raise AssertionError(f"K4 {label}: a gradient crosses segments")
            log(f"K4 backward {label}: " + ", ".join(
                f"{n} max|d| {d:.3e} |d|/tol {r:.3f}" for n, (d, r) in checks.items())
                + f" (2 ulp + {rel} RMS); with dO 0 on padded queries, dq, dk, dv exactly 0 "
                f"at the {int(pad.sum())} padded frames: ok")

            qs = A.prescale(q, scale)
            out_k, lse, out_lo = A.splash_attention_fwd_res(qs, k, v, mask)
            di = A.splash_di(out_k, out_lo, do)
            got = (A.splash_attention_bwd_dq(qs, k, v, do, lse, di, mask),
                   *A.splash_attention_bwd_dkv(qs, k, v, do, lse, di, mask))
            bf16 = dtype == torch.bfloat16
            rel_own = 0.002 if bf16 else 2e-5
            flips = (splash_flip_allowance(torch, qs, k, v, do, lse, di, mask) if bf16 else
                     (None, None, None))
            plains = (A.splash_attention_bwd_dq_plain(qs, k, v, do, lse, di, mask),
                      *A.splash_attention_bwd_dkv_plain(qs, k, v, do, lse, di, mask))
            own = [compare(torch, f"K4 {n} kernel {label} vs its plain version", g, w, rel_own,
                           extra)[1]
                   for n, g, w, extra in zip(("dq", "dk", "dv"), got, plains, flips)]
            text = f"(dq, dk, dv) |d|/tol vs their plain versions {[round(r, 3) for r in own]} " \
                   f"(2 ulp + {rel_own} RMS{' + one rounding flip' if bf16 else ''}"
            if bf16:
                text += ", without it " + str([round(tol_ratio(torch, g, w, rel_own), 3)
                                               for g, w in zip(got, plains)])
            text += ")"
            del flips, plains
            if bf16:
                f32 = [compare(torch, f"K4 {n} {label} vs the f32 reference", g, w, 0.02)[1]
                       for n, g, w in zip(("dqs", "dk", "dv"), got,
                                          splash_f32_reference(torch, qs, k, v, do, mask))]
                text += f", vs splash_f32_reference {[round(r, 3) for r in f32]} (2 ulp + 0.02 RMS)"
            log(f"  K4 backward kernels {label}: {text}: ok")
            del got
            seg = segment_mask(mask)
            lib_leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            lib_out = F.scaled_dot_product_attention(*lib_leaves, attn_mask=seg, scale=scale)
            isz = q.element_size()
            peak = PEAK_FLOPS[str(dtype)[6:]]
            flops = H * D * segment_pairs(mask)
            plain_bwd = lambda: torch.autograd.grad(want_out, leaves, do, retain_graph=True)
            lib_bwd = lambda: torch.autograd.grad(lib_out, lib_leaves, do, retain_graph=True)

            def lib_fwd():
                with torch.enable_grad():
                    return F.scaled_dot_product_attention(*lib_leaves, attn_mask=seg, scale=scale)

            d_kv = max(checks["dk"], checks["dv"])
            rows["splash_attention_fwd_res"].append(timing_row(
                torch, shape, dtype, *compare(torch, f"K4 out {label}", out, want_out, rel),
                lambda: A.splash_attention_fwd_res(qs, k, v, mask),
                lambda: A.splash_attention_plain(q, k, v, mask, scale), lib_fwd,
                (4 + (out_lo is not None)) * B * H * T * D * isz + B * T + 4 * B * H * T,
                4 * flops, peak, reps=5))
            rows["splash_attention_bwd_dkv"].append(timing_row(
                torch, shape, dtype, *d_kv,
                lambda: A.splash_attention_bwd_dkv(qs, k, v, do, lse, di, mask),
                plain_bwd, lib_bwd, 6 * B * H * T * D * isz + 8 * B * H * T + B * T,
                8 * flops, peak, reps=5))
            rows["splash_attention_bwd_dq"].append(timing_row(
                torch, shape, dtype, *checks["dq"],
                lambda: A.splash_attention_bwd_dq(qs, k, v, do, lse, di, mask),
                plain_bwd, lib_bwd, 5 * B * H * T * D * isz + 8 * B * H * T + B * T,
                6 * flops, peak, reps=5))
            for name in rows:
                r = rows[name][-1]
                log(f"  {name} {label}: kernel {r['kernel_ms']:.4f} ms, plain {r['plain_ms']:.4f}"
                    f" ms, SDPA {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']})")
            del q, k, v, do, leaves, out, grads, want_out, wants, zeroed, qs, out_k, lse, di, out_lo
            del lib_leaves, lib_out, plain_bwd, lib_bwd, seg
            torch.cuda.empty_cache()
    return rows


def report_tensor_core_kernels(rows, hmma):
    """Per tensor-core kernel at the main path's batch of 8 in bf16 (the
    attention kernels' [8, 8, T, 64], K3's [8, 1024, 512]): its time, the
    ratio to its yardstick on the same inputs and the share of its bound.
    The yardstick of an attention kernel is SDPA (one PyTorch call); K3's is
    the unfused eager chain it replaces (five PyTorch calls), since no one
    call computes its function."""
    for _, kernel, name in TENSOR_CORE_KERNELS:
        counts = {n: c for n, c in hmma.items() if kernel in n}
        for r in rows[name]:
            if r["dtype"] != "bfloat16" or r["shape"][0] != 8 or (
                    len(r["shape"]) == 4 and r["shape"][1] != 8):
                continue
            yardstick, label = ((r["library_ms"], "SDPA") if r["library_ms"] is not None else
                                (r["eager_chain_ms"], "the unfused eager chain"))
            log(f"  {name} ({kernel}, {sum(counts.values())} HMMA/HGMMA in {len(counts)} variants) "
                f"{r['shape']}: {r['kernel_ms']:.4f} ms, {r['kernel_ms'] / yardstick:.2f}x "
                f"{label} ({yardstick:.4f} ms), {r['bound_ms'] / r['kernel_ms']:.1%} of its "
                f"bound ({r['bound_ms']:.4f} ms, {r['bound_by']})")


def make_item(rng, n_frames, n_notes, units_dim, discrete=False):
    """One training item with the fields of tests/test_training.py::make_item:
    random units, a pitch curve, notes of random pitch (a fifth rests) whose
    durations add up to the frame count, and the frame-to-note alignment;
    ``discrete``: integer pitch classes, rests as class 128, as the quantized
    binarizer writes them."""
    note_dur = rng.multinomial(n_frames - n_notes, np.ones(n_notes) / n_notes) + 1
    item = {"units": rng.standard_normal((n_frames, units_dim)).astype(np.float32),
            "pitch": rng.uniform(40, 80, n_frames).astype(np.float32),
            "note_dur": note_dur.astype(np.int64),
            "unit2note": np.repeat(np.arange(1, n_notes + 1), note_dur).astype(np.int64),
            "length": n_frames, "seconds": n_frames * 512 / 44100}
    if discrete:
        midi = rng.integers(40, 80, n_notes).astype(np.int64)
        midi[rng.random(n_notes) < 0.2] = 128
        return dict(item, note_midi=midi)
    return dict(item, note_midi=rng.uniform(40, 80, n_notes).astype(np.float32),
                note_rest=rng.random(n_notes) < 0.2)


def synthetic_items(seed, n, units_dim, lo=600, hi=2000, discrete=False):
    """``n`` items of ``lo``..``hi`` frames (7-23 s of singing at 86 frames/s),
    a note every 15 to 40 frames."""
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n):
        frames = int(rng.integers(lo, hi + 1))
        items.append(make_item(rng, frames, max(4, frames // int(rng.integers(15, 41))),
                               units_dim, discrete))
    return items


def in_memory_task(config, train_items, valid_items, device="cuda"):
    """The port's task of ``config`` (``train.TASKS``) reading in-memory
    items instead of HDF5 (the pattern of tests/test_training.py's
    RecordingTask)."""
    from some_tpu_torch.train import TASKS

    class InMemoryTask(TASKS[config["task_cls"]]):
        def load_datasets(self):
            sizes = lambda items: np.array([i["length"] for i in items])
            return (train_items, sizes(train_items)), (valid_items, sizes(valid_items))

        def valid_step(self, state, batch):
            before = read_counts()
            out = super().valid_step(state, batch)
            after = read_counts()
            self.valid_launches.append({n: after[n] - before[n] for n in after})
            return out

        def train_step(self, state, batch):
            import torch

            before = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logs = super().train_step(state, batch)
            torch.cuda.synchronize()
            after = read_counts()
            self.step_records.append({
                "s": time.perf_counter() - t0, "rows": int(batch["size"]),
                "T": int(batch["units"].shape[1]), "frames": int(batch["mask"].sum()),
                "total_loss": float(logs["total_loss"]), "grad_norm": float(logs["grad_norm"]),
                "launches": {n: after[n] - before[n] for n in after}})
            return logs

    task = InMemoryTask(config, device=device)
    task.step_records = []
    task.valid_launches = []
    return task


def production_config(name="midi_conformer.yaml", **overrides):
    from some_tpu_torch.config import read_full_config

    config = read_full_config(REPO / "configs" / name)
    config.update(overrides)
    return config


def train_path(torch, workdir: pathlib.Path, n_steps: int, opt_in: bool = False,
               discrete: bool = False):
    """Trainer.fit at production width (configs/midi_conformer.yaml: 8
    dual-stream layers, dim 512, 8 x 64 heads, k 31, bf16, remat on,
    dropout 0.1) on 64 synthetic items of 600-2000 frames, batches of up to
    8 rows bucketed to 128 frames; validation and a checkpoint at the last
    step; then the infer path loads that checkpoint and transcribes a song.
    Launches are held per train step and per validation forward. ``opt_in``
    adds ``fuse_ffn: true`` and ``attention_impl: splash``: the steps run
    K4 and no K3 (training runs the unfused FFN, as in JAX), the validation
    forwards run K3 and K4's inference kernel. ``discrete``: the quantized
    task of configs/discrete.yaml (3 layers, 129 classes, cross-entropy) in
    bf16, on items with integer labels; the engine that loads its checkpoint
    is the argmax one, and its notes must be integer pitches in [0, 127]."""
    from some_tpu_torch.audio.wavio import save_wav
    from some_tpu_torch.config import save_yaml
    from some_tpu_torch.infer import load_engine, transcribe_file
    from some_tpu_torch.training.checkpoint import latest_checkpoint
    from some_tpu_torch.training.trainer import Trainer
    from some_tpu_torch.utils.midi_file import MidiFile

    tag = "discrete" if discrete else "opt-in" if opt_in else "default"
    config = production_config("discrete.yaml" if discrete else "midi_conformer.yaml",
                               val_check_interval=n_steps, num_sanity_val_steps=0,
                               log_interval=4, max_val_batch_size=1,
                               **(OPT_IN if opt_in else {}),
                               **({"pl_trainer_precision": "bf16"} if discrete else {}))
    args = config["midi_extractor_args"]
    blocks = 2 * args["lay"] + 2
    remat_blocks = 2 * args["lay"]
    log(f"{tag} train path: configs/{'discrete' if discrete else 'midi_conformer'}.yaml, lay "
        f"{args['lay']} dim {args['dim']} "
        f"heads {args['attention_heads']}x{args['attention_heads_dim']} k "
        f"{args['kernel_size']}, {config['pl_trainer_precision']}, remat "
        f"{config.get('use_remat', True)}, dropout {args['conv_drop']}, max "
        f"{config['max_batch_size']} rows x {config['max_batch_frames']} frames, bucket grid "
        f"{config['frame_bucket_grid']}, fuse_ffn {config.get('fuse_ffn', False)}, "
        f"attention_impl {config.get('attention_impl', 'auto')}")
    train_items = synthetic_items(7, 64, config["units_dim"], discrete=discrete)
    valid_items = synthetic_items(8, 3, config["units_dim"], discrete=discrete)
    work = workdir / f"train-{tag}"
    work.mkdir()
    save_yaml(config, work / "config.yaml")
    task = in_memory_task(config, train_items, valid_items)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer = Trainer(task, work)
    state = trainer.fit(max_steps=n_steps)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launched = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    records = task.step_records
    if state.step != n_steps or len(records) != n_steps:
        raise AssertionError(f"fit ran {state.step} steps ({len(records)} timed), want {n_steps}")
    attn = "splash_attention" if opt_in else "flash_attention"
    per_step = {"depthwise_conv1d": blocks + remat_blocks, "depthwise_conv1d_dx": blocks,
                "depthwise_conv1d_dw": blocks, f"{attn}_fwd_res": blocks + remat_blocks,
                f"{attn}_bwd_dkv": blocks, f"{attn}_bwd_dq": blocks}
    per_valid = {"depthwise_conv1d": blocks, attn: blocks}
    if opt_in:
        per_valid["fused_ln_ffn_residual"] = 2 * blocks
    want = {name: per_step.get(name, 0) for name in launched}
    want_valid = {name: per_valid.get(name, 0) for name in launched}
    for i, rec in enumerate(records):
        if rec["launches"] != want:
            raise AssertionError(f"{tag} train step {i} launched {rec['launches']}, want {want}")
    if not task.valid_launches or any(v != want_valid for v in task.valid_launches):
        raise AssertionError(f"{tag} validation forwards launched {task.valid_launches}, want "
                             f"{want_valid} each")
    if any(launched[name] == 0 for name in set(per_step) | set(per_valid)):
        raise AssertionError(f"a kernel of the {tag} train path never launched: {launched}")
    losses = [r["total_loss"] for r in records]
    if not all(np.isfinite(losses)) or not all(np.isfinite([r["grad_norm"] for r in records])):
        raise AssertionError(f"non-finite training logs: {records}")
    warm = records[2:]
    step_ms = statistics.median(r["s"] * 1e3 for r in warm)
    frames_per_s = sum(r["frames"] for r in warm) / sum(r["s"] for r in warm)
    log(f"{tag} train path: {n_steps} steps in {fit_s:.1f} s (fit, validation and checkpoint); "
        f"launches per step { {n: c for n, c in want.items() if c} } on every step, per "
        f"validation forward { {n: c for n, c in want_valid.items() if c} } on each of "
        f"{len(task.valid_launches)}; warm step median {step_ms:.1f} ms (synchronized per "
        f"step), {frames_per_s:.0f} frames/s; peak {peak_gib:.2f} GiB; losses "
        f"{[round(x, 4) for x in losses]}; validation {trainer.last_validation}")

    # device busy share of one more step on the largest bucket, against the
    # unprofiled wall of the same step
    big = max(range(len(train_items) // 8), key=lambda i: max(
        train_items[j]["length"] for j in range(8 * i, 8 * i + 8)))
    batch = task.to_device(task.collate(train_items[8 * big: 8 * big + 8]))
    task.train_step(state, batch)
    walls = []
    for _ in range(3):
        task.train_step(state, batch)
        walls.append(task.step_records[-1]["s"])
    profiled = profile_pass(torch, lambda: (task.train_step(state, batch),
                                            torch.cuda.synchronize()))
    profiled["busy_share_of_unprofiled_wall"] = (profiled["device_ms"] / 1e3
                                                 / statistics.median(walls))
    profiled["batch"] = [int(batch["size"]), int(batch["units"].shape[1])]
    log(f"{tag} train step profile: " + json.dumps(profiled))

    ckpt = latest_checkpoint(work)
    if ckpt is None or ckpt.name != f"model_ckpt_steps_{n_steps}.ckpt":
        raise AssertionError(f"no checkpoint of step {n_steps} in {work}: {ckpt}")
    validation = trainer.last_validation
    if not validation or not all(np.isfinite(list(validation.values()))):
        raise AssertionError(f"validation gave {validation}")
    del state, trainer, task, batch
    torch.cuda.empty_cache()
    engine = load_engine(ckpt, device="cuda", quiet=True)
    save_wav(workdir / "trained.wav", make_song(4242, phrases=2), SR)
    midi = transcribe_file(engine, workdir / "trained.wav", workdir / f"trained-{tag}.mid")
    pitches = [n["note"] for n in MidiFile.load(midi).notes()]
    notes = len(pitches)
    if discrete and (type(engine).__name__ != "QuantizedMIDIExtractionInference"
                     or not all(0 <= p <= 127 for p in pitches)):
        raise AssertionError(f"the discrete checkpoint loaded into {type(engine).__name__}, "
                             f"pitches {sorted(set(pitches))}")
    log(f"infer from the {tag} trained checkpoint {ckpt.name}: {type(engine).__name__}, "
        f"{engine.forwards} forwards, {notes} notes in {midi.name}")
    del engine
    torch.cuda.empty_cache()
    return {"steps": n_steps, "fit_s": fit_s, "warm_step_ms_median": step_ms,
            "frames_per_s": frames_per_s, "peak_gib": peak_gib, "step_records": records,
            "launches_per_step": want, "launches_per_validation_forward": want_valid,
            "validation": validation, "profile": profiled, "infer_notes": notes}, launched


def step_grads(torch, task, state, batch):
    """One forward and backward of the task's train step, no update: the
    logs and every parameter's gradient."""
    from some_tpu_torch.nn.conformer import set_dropout_step
    from some_tpu_torch.training.optimizers import global_norm

    model = state.model
    model.train()
    set_dropout_step(model, task.config["seed"], 0)
    b = task.to_device(batch)
    losses = task.compute_losses(model(**task.model_inputs(b)), b)
    total = sum(losses.values())
    model.zero_grad(set_to_none=True)
    total.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    logs = {k: float(v.detach()) for k, v in losses.items()}
    logs["total_loss"] = float(total.detach())
    logs["grad_norm"] = float(global_norm(list(grads.values())))
    return logs, grads


def kernel_vs_plain_step(torch, opt_in: bool = False):
    """One train step from one state and one batch with dropout 0, through
    the kernels and through the plain versions (the same config with the
    test-only ``impl`` switches at 'plain'), production width; ``opt_in``
    adds ``fuse_ffn: true`` and ``attention_impl: splash``. Losses and grad_norm:
    relative difference <= 1e-4 in f32, 2e-2 in bf16. Every parameter's
    gradient: ||g_kernel - g_plain|| <= rel x max(||g_plain||, 1e-3 x the
    gradient's RMS over the model x sqrt(its size)), rel 1e-3 in f32 and 0.1
    in bf16 (the two round at other points through 18 blocks). The
    depthwise biases are held apart: the BatchNorm after the conv cancels
    them, so their gradient is 0 in exact arithmetic and float noise in both
    paths, whose norm must stay below 0.01 (f32) or 0.1 (bf16) x the
    model's gradient RMS x sqrt(size)."""
    from some_tpu_torch.nn.conformer import set_kernel_impl

    tag = "opt-in" if opt_in else "default"
    items = synthetic_items(9, 4, 80, lo=900, hi=1100)
    result = {}
    for precision, rel_log, rel_grad in (("32-true", 1e-4, 1e-3), ("bf16", 2e-2, 0.1)):
        config = production_config(pl_trainer_precision=precision,
                                   **(OPT_IN if opt_in else {}))
        config["midi_extractor_args"] = dict(config["midi_extractor_args"], conv_drop=0.0,
                                             ffn_latent_drop=0.0, ffn_out_drop=0.0,
                                             attention_drop=0.0)
        runs = {}
        for impl in ("kernel", "plain"):
            task = in_memory_task(config, items, items)
            state = task.init_state(seed=11)
            set_kernel_impl(state.model, "auto" if impl == "kernel" else impl)
            batch = task.collate(items)
            reset_counts()
            runs[impl] = step_grads(torch, task, state, batch)
            counts = read_counts()
            if (impl == "plain") == any(counts.values()):
                raise AssertionError(f"{tag} {precision} {impl} path launches {counts}")
            del task, state
        (logs_k, grads_k), (logs_p, grads_p) = runs["kernel"], runs["plain"]
        for key in logs_k:
            if abs(logs_k[key] - logs_p[key]) > rel_log * abs(logs_p[key]):
                raise AssertionError(f"{tag} {precision} {key}: kernel {logs_k[key]} plain "
                                     f"{logs_p[key]}")
        n_all = sum(g.numel() for g in grads_p.values())
        rms_all = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads_p.values()) / n_all))
        errs = []
        for name, gp in grads_p.items():
            scale = 1e-3 * rms_all * gp.numel() ** 0.5
            if name.endswith("conv.dw.bias"):
                # the BatchNorm right after the depthwise conv removes any
                # per-channel constant: this gradient is 0 in exact arithmetic,
                # so both paths must give float noise far below the model's scale
                size = max(float(grads_k[name].float().norm()), float(gp.float().norm()))
                limit = (0.1 if precision == "bf16" else 0.01) * rms_all * gp.numel() ** 0.5
                if size > limit:
                    raise AssertionError(f"{precision}: {name} has gradient norm {size:.3e}, "
                                         f"want below {limit:.3e}")
                continue
            err = float((grads_k[name].float() - gp.float()).norm()) / max(
                float(gp.float().norm()), scale)
            errs.append((err, name))
        errs.sort(reverse=True)
        worst = errs[0]
        if worst[0] > rel_grad:
            raise AssertionError(f"{precision}: gradient of {worst[1]} off by {worst[0]:.3e} "
                                 f"(relative), limit {rel_grad}; worst {errs[:5]}")
        log(f"{tag} kernel vs plain train step, {precision}, 4 rows x {batch['units'].shape[1]}"
            f" frames: losses kernel {logs_k} plain {logs_p}; worst parameter gradients "
            f"{[(n, f'{e:.3e}') for e, n in errs[:3]]} relative (limit {rel_grad}); the "
            f"depthwise biases' gradients are float noise in both: ok")
        result[precision] = {"kernel": logs_k, "plain": logs_p, "worst_grad_rel": worst[0],
                             "worst_grad_param": worst[1]}
        del runs, grads_k, grads_p
        torch.cuda.empty_cache()
    return result


def overfit_f32(torch, n_steps=30):
    """f32, production width, one fixed batch of 4 rows, warmup_steps cut to
    10, dropout as configured: the mean loss of the last 5 steps must be at
    most a quarter of that of the first 5 (measured on the H100: about a
    tenth). Trained output heads alone would lower the loss on one fixed
    batch too, so a loose margin would pass a backbone cut off from its
    gradients."""
    items = synthetic_items(10, 4, 80, lo=900, hi=1100)
    config = production_config(pl_trainer_precision="32-true")
    config["lr_scheduler_args"] = dict(config["lr_scheduler_args"], warmup_steps=10)
    task = in_memory_task(config, items, items)
    state = task.init_state()
    batch = task.to_device(task.collate(items))
    losses = [float(task.train_step(state, batch)["total_loss"]) for _ in range(n_steps)]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    log(f"f32 overfit, {n_steps} steps on one batch: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"mean of the first 5 {first:.4f}, of the last 5 {last:.4f} (need <= 0.25 x first)")
    if not last <= 0.25 * first:
        raise AssertionError(f"f32 loss did not fall: {losses}")
    del task, state, batch
    torch.cuda.empty_cache()
    return {"losses": losses, "first5_mean": first, "last5_mean": last}


# ---- serving what users bring: int8, the discrete model, the dft mel,
# reference Lightning files, the oversize split ----

INT8_PEAK_OPS = 1979e12  # H100 SXM int8 tensor cores, dense (the data sheet)


def check_int8_products(torch):
    """One int8 product at the shape of a macaron FFN's first product on a
    bucket of 8 x 1024 frames ([8192, 512] x [512, 2048]): ``torch._int_mm``
    (cuBLASLt) equals an int64 product of the same codes bit for bit, and so
    does ``int8_matmul``'s f32 rescale. Times (CUDA events, one call):
    ``int8_matmul`` (bf16 out) against the bf16 ``F.linear`` of the same
    shape, ``torch._int_mm`` alone, ``quantize_activation`` and the whole
    ``dynamic_int8_dense``; the int8 product's bound."""
    import torch.nn.functional as F
    from some_tpu_torch.ops.quant import (
        dynamic_int8_dense, int8_matmul, quantize_activation, quantize_weight,
    )

    gen = torch.Generator(device="cuda").manual_seed(8)
    M, K, N = 8192, 512, 2048
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((N, K), generator=gen, device="cuda") * K ** -0.5
    q, scale = quantize_weight(w.t().cpu().numpy())
    wq = torch.from_numpy(np.ascontiguousarray(q.T)).cuda()
    sw = torch.from_numpy(scale).cuda()
    xq, sx = quantize_activation(x)
    # the exact product as int64: in float64 on the card every partial sum is
    # an integer below 2^53 (|sum| <= 127^2 x 512), so no rounding happens
    exact = torch.matmul(xq.double(), wq.double().t()).long()
    if not torch.equal(torch._int_mm(xq, wq.t()).long(), exact):
        raise AssertionError("torch._int_mm differs from the int64 product")
    got = int8_matmul(xq, sx, wq, sw, torch.float32)
    if not torch.equal(got, exact.float() * (sx * sw)):
        raise AssertionError("int8_matmul's rescale differs from the exact product's")
    wb = w.to(torch.bfloat16)
    bound_ms, bound_by = bound(M * K + K * N + 2 * M * N + 4 * N, 2 * M * K * N, INT8_PEAK_OPS)
    row = {"shape": [M, K, N], "bit_for_bit_vs_int64": True,
           "int8_matmul_ms": median_ms(torch, lambda: int8_matmul(xq, sx, wq, sw,
                                                                  torch.bfloat16)),
           "int_mm_ms": median_ms(torch, lambda: torch._int_mm(xq, wq.t())),
           "quantize_activation_ms": median_ms(torch, lambda: quantize_activation(x)),
           "dynamic_int8_dense_ms": median_ms(torch, lambda: dynamic_int8_dense(
               x, wq, sw, torch.bfloat16)),
           "bf16_linear_ms": median_ms(torch, lambda: F.linear(x, wb)),
           "int8_bound_ms": bound_ms, "int8_bound_by": bound_by}
    log("int8 product [8192, 512] x [512, 2048]: torch._int_mm bit for bit with int64, "
        "the rescale too; " + json.dumps(row))
    return row


def discrete_infer(torch, workdir: pathlib.Path, setup: dict):
    """The discrete model (configs/discrete.yaml: 3 dual-stream layers, dim
    512, 8 x 64 heads, k 31, 129 classes, its own precision, 32-true) with
    seeded weights in the JAX layout, carried across, through the infer CLI
    on song 0: prewarm of the song's buckets, then ``transcribe_file``
    (launches = 2 x per forward x graphs); integer pitches in [0, 127];
    ``dispatch_check`` against an eager engine on the song's chunks (graph
    vs eager bit for bit, each graph's and a replay's hand-written kernels:
    8 K1 + 8 K2)."""
    from some_tpu_torch.audio.wavio import load_wav
    from some_tpu_torch.compat.from_jax import jax_params_to_state_dict, random_jax_variables
    from some_tpu_torch.config import save_yaml
    from some_tpu_torch.inference.base_infer import pick_bucket, set_dispatch
    from some_tpu_torch.inference.pipeline import slice_waveform
    from some_tpu_torch.infer import load_engine, transcribe_file
    from some_tpu_torch.nn.model import build_midi_extractor
    from some_tpu_torch.utils.checkpoint import save_checkpoint
    from some_tpu_torch.utils.midi_file import MidiFile

    config = production_config("discrete.yaml", transfer_dtype="int16")
    args = config["midi_extractor_args"]
    blocks = 2 * args["lay"] + 2
    d = workdir / "discrete"
    d.mkdir()
    variables = random_jax_variables(build_midi_extractor(config), seed=271828)
    save_checkpoint(d / "model.pt", jax_params_to_state_dict(variables["params"],
                                                             variables["batch_stats"]))
    save_yaml(config, d / "config.yaml")
    wav = setup["wavs"][0]
    chunks = [c["waveform"] for c in slice_waveform(load_wav(wav, sr=SR)[0], SR)]
    buckets = sorted({pick_bucket(len(c) // config["hop_size"] + 1) for c in chunks})
    per_forward = {"depthwise_conv1d": blocks, "flash_attention": blocks}
    reset_counts()
    graph = load_engine(d / "model.pt", device="cuda", quiet=True)
    if type(graph).__name__ != "QuantizedMIDIExtractionInference":
        raise AssertionError(f"task {config['task_cls']} loaded {type(graph).__name__}")
    n_graphs = graph.prewarm(buckets, rows=(1, 2, 3, 4, 6, 8))
    t0 = time.perf_counter()
    midi = transcribe_file(graph, wav, workdir / "discrete-graph.mid")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launched = read_counts()
    want = {n: 2 * per_forward.get(n, 0) * n_graphs for n in launched}
    if launched != want:
        raise AssertionError(f"discrete graph path launches {launched}, want {want}")
    pitches = [n["note"] for n in MidiFile.load(midi).notes()]
    if not pitches or not all(0 <= p <= 127 for p in pitches):
        raise AssertionError(f"discrete notes: {len(pitches)}, pitches {sorted(set(pitches))}")
    eager = load_engine(d / "model.pt", device="cuda", quiet=True)
    set_dispatch(eager, "eager")
    dispatch = dispatch_check(torch, graph, eager, chunks, per_forward, "discrete")
    # device time of song 0's graph pass against the continuous model's in
    # the same precision (the default configuration's f32 engine, prewarmed)
    continuous = load_engine(workdir / "default-32-true" / "model.pt", device="cuda", quiet=True)
    continuous.prewarm(buckets, rows=(1, 2, 3, 4, 6, 8))
    device = {name: profile_pass(torch, lambda: transcribe_file(
        engine, wav, workdir / f"discrete-{name}-prof.mid"))["device_ms"]
        for name, engine in (("discrete", graph), ("continuous", continuous))}
    log(f"discrete infer (configs/discrete.yaml, lay {args['lay']}, {config['midi_num_bins']} "
        f"classes, {config['pl_trainer_precision']}): {n_graphs} graphs of buckets {buckets}, "
        f"first pass {first_s:.3f} s, {len(pitches)} notes, pitches "
        f"{min(pitches)}..{max(pitches)}, launches (captures) "
        f"{ {n: c for n, c in launched.items() if c} }; device ms of song 0's graph pass "
        f"{device} (the continuous model's in the same precision beside it); graph vs eager "
        + json.dumps(dispatch))
    del graph, eager, continuous
    torch.cuda.empty_cache()
    return {"notes": len(pitches), "graphs": n_graphs, "first_s": first_s,
            "device_ms_song0": device, "launches": launched,
            "dispatch_check": dispatch}, launched


def f64_log_mel(wave: np.ndarray, config: dict) -> np.ndarray:
    """The log-mel of [rows, samples] audio in float64 on the host (numpy's
    FFT of the periodic-Hann frames, the filterbank in f64): the yardstick
    both f32 spectra are held against."""
    from some_tpu_torch.audio.mel import hann_window, mel_filterbank

    win, hop = config["win_size"], config["hop_size"]
    x = np.pad(wave.astype(np.float64), ((0, 0), (win // 2, (win + 1) // 2)))
    frames = np.lib.stride_tricks.sliding_window_view(x, win, axis=-1)[:, ::hop]
    magnitude = np.abs(np.fft.rfft(frames * hann_window(win), axis=-1))
    basis = mel_filterbank(config["audio_sample_rate"], win, config["units_dim"],
                           config["fmin"], config["fmax"]).astype(np.float64)
    return np.log(np.maximum(magnitude @ basis.T, 1e-5))


def mel_check(torch, setup: dict, workdir: pathlib.Path):
    """``mel_method: dft`` in one default bf16 engine on the four songs
    (graph dispatch after prewarm), its log-mel against the rfft one on the
    card, on every group's real frames: at most 1e-2 apart wherever the mel
    is at least 1e-3 (100 x the clamp), the JAX docstring's figure; below
    that the direct f32 sum loses the quiet bins to cancellation (on the
    CPU JAX's own dft and rfft are 0.027 apart on these songs), so there
    both are held against an f64 log-mel and their largest errors are
    recorded. Then note F1 against the rfft engine's (the default bf16 main
    path's MIDI files), the warm RTF, the two mels' device time on the
    largest group (torch.profiler), and the pass's device ms by group."""
    from some_tpu_torch.audio.wire import decode_wire_device
    from some_tpu_torch.config import save_yaml
    from some_tpu_torch.infer import load_engine, transcribe_file
    from some_tpu_torch.ops.melspec import LogMelSpec
    from some_tpu_torch.utils.midi_file import MidiFile, midi_notes_to_arrays
    from some_tpu_torch.utils.note_f1 import note_f1

    d = workdir / "dft-bf16"
    d.mkdir()
    save_yaml(dict(setup["config"], pl_trainer_precision="bf16", mel_method="dft"),
              d / "config.yaml")
    os.symlink(setup["ckpt"], d / "model.pt")
    engine = load_engine(d / "model.pt", device="cuda", quiet=True)
    engine.prewarm(setup["buckets"])
    midis = [transcribe_file(engine, wav, workdir / f"dft-{i}.mid")
             for i, wav in enumerate(setup["wavs"])]
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        for i, wav in enumerate(setup["wavs"]):
            transcribe_file(engine, wav, workdir / f"dft-warm-{i}.mid")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    prof = profile_pass(torch, lambda: [transcribe_file(engine, wav, workdir / f"dft-p{i}.mid")
                                        for i, wav in enumerate(setup["wavs"])])
    rfft_midis = [workdir / f"default-bf16-graph-{i}.mid" for i in range(len(setup["wavs"]))]
    f1 = [note_f1(midi_notes_to_arrays(MidiFile.load(a)), midi_notes_to_arrays(MidiFile.load(b)),
                  onset_tolerance=0.05, pitch_tolerance=0.5).f1 for a, b in zip(rfft_midis, midis)]
    config = setup["config"]
    rfft = LogMelSpec(n_mels=config["units_dim"], sample_rate=config["audio_sample_rate"],
                      win_length=config["win_size"], hop_length=config["hop_size"],
                      fmin=config["fmin"], fmax=config["fmax"], device="cuda")
    groups, _ = engine.bucket_groups(setup["chunks"])
    err = {"dft_vs_rfft_above_1e-3": 0.0, "dft_vs_rfft": 0.0, "dft_vs_f64": 0.0,
           "rfft_vs_f64": 0.0}
    largest = None
    for _, audio, mask in groups:
        wave = decode_wire_device(torch.from_numpy(audio).cuda(), engine.wire,
                                  n_samples=mask.shape[1] * engine.hop - 1)
        got, want = engine.mel(wave).cpu().numpy(), rfft(wave).cpu().numpy()
        ref = f64_log_mel(wave.cpu().numpy(), config)
        loud = mask[..., None] & (ref >= np.log(1e-3))
        real = np.broadcast_to(mask[..., None], ref.shape)
        for key, value in (("dft_vs_rfft_above_1e-3", np.abs(got - want)[loud]),
                           ("dft_vs_rfft", np.abs(got - want)[real]),
                           ("dft_vs_f64", np.abs(got - ref)[real]),
                           ("rfft_vs_f64", np.abs(want - ref)[real])):
            err[key] = max(err[key], float(value.max()))
        if largest is None or wave.numel() > largest.numel():
            largest = wave
    mel_ms = {name: {"ms": median_ms(torch, lambda: mel(largest)),
                     "device_ms": device_ms(torch, lambda: mel(largest), calls=10)}
              for name, mel in (("dft", engine.mel), ("rfft", rfft))}
    audio_s = setup["audio_s"]
    log(f"dft mel, default bf16: log-mel max |d| on the songs' real frames {err} (dft vs "
        f"rfft limit 1e-2 where the mel >= 1e-3); note F1 against the rfft engine {f1}; warm "
        f"RTF {audio_s / statistics.median(walls):.2f}x; mel device ms on "
        f"{list(largest.shape)} samples: {mel_ms}; pass device ms "
        f"{prof['device_ms']:.1f}, by group {prof['by_group_ms']}")
    if not err["dft_vs_rfft_above_1e-3"] <= 1e-2:
        raise AssertionError(f"dft log-mel differs from rfft: {err}")
    del engine
    torch.cuda.empty_cache()
    return {"max_abs_logmel": err, "f1_vs_rfft": f1,
            "rtf_warm_median": audio_s / statistics.median(walls), "mel_device_ms": mel_ms,
            "mel_samples_shape": list(largest.shape), "profile": prof}


class AttributeDict(dict):
    """Stands for Lightning's hyper-parameter dict: pickled as a class that
    ``torch.load(weights_only=True)`` refuses, as a Lightning file's are."""


def lightning_check(torch, workdir: pathlib.Path, setup: dict):
    """A reference Lightning checkpoint at production width: ``OracleModel``
    (tests/torch_oracle.py, the reference's key layout, torch only; 8
    layers, dim 512, 8 x 64 heads, k 31, 80 -> 128) with random BatchNorm
    statistics from a seed, saved as ``{"state_dict": {"model." + k: v},
    "hyper_parameters": ...}`` with config.yaml beside it (32-true). Loaded
    through ``load_engine``; the port's f32 forward (kernels on) against
    ``OracleModel``'s on the same input on the card, atol 5e-5 + rtol 1e-4
    (the JAX package's oracle tolerance), the measured max |d| printed; then
    the CLI writes a MIDI file of song 0."""
    sys.path.insert(0, str(REPO / "tests"))
    from torch_oracle import OracleModel

    from some_tpu_torch.config import save_yaml
    from some_tpu_torch.infer import load_engine, transcribe_file
    from some_tpu_torch.utils.midi_file import MidiFile

    config = dict(setup["config"], pl_trainer_precision="32-true")
    args = config["midi_extractor_args"]
    torch.manual_seed(161803)
    oracle = OracleModel(args["lay"], args["dim"], config["units_dim"], config["midi_num_bins"],
                         kernel_size=args["kernel_size"], heads=args["attention_heads"],
                         dim_head=args["attention_heads_dim"]).eval()
    with torch.no_grad():
        for m in oracle.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    d = workdir / "lightning"
    d.mkdir()
    torch.save({"state_dict": {f"model.{k}": v for k, v in oracle.state_dict().items()},
                "hyper_parameters": AttributeDict(config), "epoch": 0, "global_step": 0},
               d / "model.ckpt")
    save_yaml(config, d / "config.yaml")
    engine = load_engine(d / "model.ckpt", device="cuda", quiet=True)
    oracle = oracle.cuda()
    x = torch.randn((4, 1024, config["units_dim"]), generator=torch.Generator(
        device="cuda").manual_seed(9), device="cuda")
    mask = torch.ones((4, 1024), dtype=torch.bool, device="cuda")
    reset_counts()
    with torch.no_grad():
        got = engine.model(x, mask=mask, sig=True)
        launched = read_counts()
        want = oracle(x, mask=mask, sig=True)
    if not launched["depthwise_conv1d"] or not launched["flash_attention"]:
        raise AssertionError(f"the Lightning forward ran no kernel: {launched}")
    errs = {}
    for name, g, w in zip(("probs", "bounds"), got, want):
        d_abs = (g - w).abs()
        errs[name] = {"max_abs": float(d_abs.max()),
                      "max_over_tol": float((d_abs / (5e-5 + 1e-4 * w.abs())).max())}
    midi = transcribe_file(engine, setup["wavs"][0], workdir / "lightning.mid")
    notes = len(MidiFile.load(midi).notes())
    log(f"Lightning checkpoint (OracleModel {args['lay']} x {args['dim']}, "
        f"{sum(v.numel() for v in oracle.state_dict().values())} values): f32 forward through "
        f"the kernels ({ {n: c for n, c in launched.items() if c} }) against OracleModel's: "
        f"{errs} (tolerance 5e-5 + 1e-4 |want|); the CLI wrote {notes} notes")
    if max(e["max_over_tol"] for e in errs.values()) > 1.0 or notes == 0:
        raise AssertionError(f"Lightning checkpoint: {errs}, {notes} notes")
    del engine, oracle
    torch.cuda.empty_cache()
    return {"vs_oracle": errs, "notes": notes, "launches": launched}


def oversize_split(torch, workdir: pathlib.Path, setup: dict):
    """Song 0 through one default bf16 engine whose frame buckets stop at
    256, so each of its chunks splits at the bucket boundary and
    ``merge_parts`` joins the parts: graph dispatch (after prewarm) against
    eager on every group bit for bit with its graphs' kernels
    (``dispatch_check``); the song's notes, graph against the plain path
    with the same buckets, note F1 >= 0.95 (bf16)."""
    from some_tpu_torch.audio.wavio import load_wav
    from some_tpu_torch.infer import load_engine, transcribe_file
    from some_tpu_torch.inference.base_infer import set_dispatch
    from some_tpu_torch.inference.pipeline import slice_waveform
    from some_tpu_torch.nn.conformer import set_kernel_impl
    from some_tpu_torch.utils.midi_file import MidiFile, midi_notes_to_arrays
    from some_tpu_torch.utils.note_f1 import note_f1

    model = workdir / "default-bf16" / "model.pt"
    buckets = (128, 192, 256)
    wav = setup["wavs"][0]
    chunks = [c["waveform"] for c in slice_waveform(load_wav(wav, sr=SR)[0], SR)]
    engines = {}
    for name in ("graph", "eager", "plain"):
        engines[name] = load_engine(model, device="cuda", quiet=True)
        engines[name].frame_buckets = buckets
    set_dispatch(engines["eager"], "eager")
    set_dispatch(engines["plain"], "eager")
    set_kernel_impl(engines["plain"].model, "plain")
    groups, n_parts = engines["graph"].bucket_groups(chunks)
    if max(n_parts) < 2:
        raise AssertionError(f"no chunk of song 0 split at bucket {buckets[-1]}: {n_parts}")
    n_graphs = engines["graph"].prewarm(sorted({mask.shape[1] for _, _, mask in groups}),
                                        rows=(1, 2, 3, 4, 6, 8))
    blocks = setup["blocks"]
    per_forward = {"depthwise_conv1d": blocks, "flash_attention": blocks}
    dispatch = dispatch_check(torch, engines["graph"], engines["eager"], chunks, per_forward,
                              "oversize split")
    midis = {name: transcribe_file(engines[name], wav, workdir / f"oversize-{name}.mid")
             for name in ("graph", "plain")}
    f1 = note_f1(midi_notes_to_arrays(MidiFile.load(midis["plain"])),
                 midi_notes_to_arrays(MidiFile.load(midis["graph"])),
                 onset_tolerance=0.05, pitch_tolerance=0.5).f1
    log(f"oversize split (frame buckets {buckets}, song 0: chunks split into {n_parts} parts; "
        f"{n_graphs} graphs prewarmed, {engines['graph'].graphs_captured} held): graph vs "
        f"eager " + json.dumps(dispatch) + f"; note F1 graph vs plain {f1:.4f} (need >= 0.95)")
    if f1 < 0.95:
        raise AssertionError(f"oversize split: note F1 graph vs plain {f1}")
    del engines
    torch.cuda.empty_cache()
    return {"parts": n_parts, "graphs": n_graphs, "dispatch_check": dispatch,
            "f1_vs_plain": f1}


def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True)
    return float(smi.stdout.strip().splitlines()[0])


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
    sm_clock_mhz = max_sm_clock_mhz()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    from some_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build()
    log(f"build: {len(libs)} kernels in {time.perf_counter() - t0:.1f} s")
    registers = {}
    for name, path in libs.items():
        report = path.with_suffix(".log").read_text()
        regs = kernel_registers(report)
        registers.update(regs)
        spills = sum(int(line.split(" bytes spill stores")[0].split()[-1])
                     for line in report.splitlines() if "spill stores" in line)
        log(f"  {name}: {len(regs)} kernel variants, at most {max(regs.values())} registers, "
            f"{spills} bytes of spill stores")
    report_depthwise_variants(libs["depthwise_conv"], _build.nvcc_path())
    hmma = hmma_counts(libs, _build.nvcc_path())
    log("tensor-core instructions (HMMA, HGMMA) per kernel variant (cuobjdump -sass): "
        + json.dumps(hmma))
    log("registers of the tensor-core kernels' variants: " + json.dumps(
        {n: r for n, r in registers.items()
         if any(kernel in n for _, kernel, _ in TENSOR_CORE_KERNELS)}))

    phase_s = {}

    def phase(name, fn, *args, **kwargs):
        """Run one phase, log and keep its seconds."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        phase_s[name] = time.perf_counter() - t0
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return out

    rows = {"depthwise_conv1d": phase("check_depthwise", check_depthwise, torch, sm_clock_mhz),
            "flash_attention": phase("check_attention", check_attention, torch)}
    rows.update(phase("check_depthwise_backward", check_depthwise_backward, torch,
                      sm_clock_mhz))
    rows.update(phase("check_attention_backward", check_attention_backward, torch))
    rows["fused_ln_ffn_residual"] = phase("check_fused_ffn", check_fused_ffn, torch)
    rows["splash_attention"] = phase("check_splash", check_splash, torch)
    rows.update(phase("check_splash_backward", check_splash_backward, torch))
    report_tensor_core_kernels(rows, hmma)

    launches, results = {}, {}
    results["int8_product"] = phase("int8_product", check_int8_products, torch)
    with tempfile.TemporaryDirectory(prefix="some_tpu_torch_smoke_") as tmp:
        work = pathlib.Path(tmp)
        setup = infer_setup(work)
        for opt_in in (False, True):
            tag = "opt_in" if opt_in else "default"
            results[f"infer_{tag}"], infer_launches = phase(
                f"infer_{tag}", main_path, torch, work, setup, opt_in)
            launches[f"infer_{tag}"] = infer_launches["graph"]
            launches[f"infer_{tag}_eager"] = infer_launches["eager"]
            results[f"train_{tag}"], launches[f"train_{tag}"] = phase(
                f"train_{tag}", train_path, torch, work, 8, opt_in)
            results[f"kernel_vs_plain_train_step_{tag}"] = phase(
                f"kernel_vs_plain_train_step_{tag}", kernel_vs_plain_step, torch, opt_in)
        # int8 serving: the default configuration in bf16 and f32, the opt-in one in bf16
        for opt_in, precisions in ((False, ("bf16", "32-true")), (True, ("bf16",))):
            tag = ("opt_in" if opt_in else "default") + "_int8"
            results[f"infer_{tag}"], infer_launches = phase(
                f"infer_{tag}", main_path, torch, work, setup, opt_in, True, precisions)
            launches[f"infer_{tag}"] = infer_launches["graph"]
            launches[f"infer_{tag}_eager"] = infer_launches["eager"]
        results["dft_mel"] = phase("dft_mel", mel_check, torch, setup, work)
        results["oversize_split"] = phase("oversize_split", oversize_split, torch, work, setup)
        results["infer_discrete"], launches["infer_discrete"] = phase(
            "infer_discrete", discrete_infer, torch, work, setup)
        results["train_discrete"], launches["train_discrete"] = phase(
            "train_discrete", train_path, torch, work, 8, discrete=True)
        results["lightning"] = phase("lightning", lightning_check, torch, work, setup)
        launches["lightning"] = results["lightning"]["launches"]
        # after every profiled replay: with these 66 graphs captured earlier
        # in the process, torch.profiler has missed a kernel record of a replay
        model = work / "default-bf16" / "model.pt"
        results["full_prewarm"] = phase("full_prewarm", full_prewarm, torch, model)
        results["cold_cli"] = phase("cold_cli", cold_cli, torch, model, setup["wavs"][0], work)
    results["f32_overfit"] = phase("f32_overfit", overfit_f32, torch)

    # the port's bench, shortened (2 batches a round, a 4-phrase song)
    from some_tpu_torch import bench

    bench_line = phase("bench", bench.measure, "cuda", iters=2, phrases=4)
    log("bench: SOME_BENCH_ITERS=2, SOME_BENCH_PHRASES=4")
    torch.cuda.empty_cache()
    results["phase_s"] = phase_s
    log(f"phases: {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}; total "
        f"{time.perf_counter() - START:.1f} s since the script started")

    flash_py = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    splash_py = "jax/experimental/pallas/ops/tpu/splash_attention/splash_attention_kernel.py"
    kernels = (
        ("depthwise_conv1d", "depthwise_conv.cu", "some_tpu/ops/depthwise.py:24"),
        ("flash_attention", "flash_attention.cu", "some_tpu/ops/attention.py:61"),
        ("depthwise_conv1d_dx", "depthwise_conv.cu", "some_tpu/ops/depthwise.py:126"),
        ("depthwise_conv1d_dw", "depthwise_conv.cu", "some_tpu/ops/depthwise.py:127"),
        ("flash_attention_fwd_res", "flash_attention.cu", f"{flash_py}:234"),
        ("flash_attention_bwd_dkv", "flash_attention_bwd.cu", f"{flash_py}:941"),
        ("flash_attention_bwd_dq", "flash_attention_bwd.cu", f"{flash_py}:1287"),
        ("fused_ln_ffn_residual", "fused_ffn.cu", "some_tpu/ops/fused_ffn.py:27"),
        ("splash_attention", "splash_attention.cu", f"{splash_py}:696"),
        ("splash_attention_fwd_res", "splash_attention.cu", f"{splash_py}:696"),
        ("splash_attention_bwd_dkv", "splash_attention_bwd.cu", f"{splash_py}:1669"),
        ("splash_attention_bwd_dq", "splash_attention_bwd.cu", f"{splash_py}:1307"))

    def entry(name, source, replaces):
        head = rows[name][0]  # [8, ...] bf16: the production dtype at a main-path batch
        by_path = {path: counts[name] for path, counts in launches.items()}
        tensor_core = [kernel for _, kernel, wrapper in TENSOR_CORE_KERNELS if wrapper == name]
        return {"name": name, "route": "cuda", "source": f"some_tpu_torch/csrc/{source}",
                "bf16_hmma": ({n: c for n, c in hmma.items() if tensor_core[0] in n}
                              if tensor_core else None),
                "bf16_registers": ({n: r for n, r in registers.items() if tensor_core[0] in n}
                                   if tensor_core else None),
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "launches_per_train_step": {
                    tag: results[f"train_{tag}"]["launches_per_step"][name]
                    for tag in ("default", "opt_in", "discrete")},
                "max_abs_err": max(r["max_abs_diff"] for r in rows[name]),
                "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"],
                **{key: head[key] for key in ("device_ms", "library_device_ms", "host_ms",
                                              "fp32_floor_ms", "eager_chain_ms",
                                              "kernel_ms_back_to_back",
                                              "eager_chain_ms_back_to_back") if key in head},
                "shape": head["shape"],
                "dtype": head["dtype"], "card": card, "shapes": rows[name]}

    print(json.dumps(bench_line), flush=True)
    print(json.dumps({"kernels": [entry(*k) for k in kernels]}), flush=True)
    print(json.dumps(dict(results, card=card)), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
