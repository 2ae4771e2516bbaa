#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``some_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

(``python3 chip_smoke.py --mesh`` runs the ``mesh`` phase alone on its
set-up, to check the two-card branch on a machine with two cards; it is not
the smoke test and prints no ``ok`` line.)

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
     eager chain) and the bound; then each tensor-core wrapper's route
     (``routes``): the variant it launched for bf16 and for f32 inputs, read
     from the libraries' own launch tables (``csrc/launch_counts.cuh``);
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
  5b. training, the rest (``train_rest``), in default bf16 from launch
     counts at 0: from the default train phase's checkpoint cut to 2 layers
     (finetuning), ``accumulate_grad_batches: 2`` with ``in_proj_midi`` frozen, 6
     micro-steps straight through and 3 + an interrupt + a resume to 6 (bit
     for bit with the straight run; the frozen weights bit for bit); one
     validation forward's
     outputs decoded on the card and on the CPU (integers equal, values to
     f32 rounding); finetuning from a reference Lightning file with
     ``bound_head`` ignored (every other leaf the file's) and two steps;
     every remat policy (one forward and backward at 8 x 2048 each: loss
     and every gradient equal to ``nothing``'s bit for bit, K1/K2
     launches, peak memory, step wall, device time), and
     ``save_attn_conv`` with splash; the profile window (a trace holding K1
     and K2 records, the step count after it); two steps in a one-process
     NCCL group equal to two without one, bit for bit;
  5c. the compiled train and valid steps (``train_graph``), from launch
     counts at 0: one CUDA graph per batch bucket and accumulation
     position (a bucket's second visit captures its step) against the
     test-only eager dispatch from equal seeded states, at production width
     in bf16, default and opt-in, over two buckets in turns (8 x 2048 and
     8 x 1024, 6 steps): losses, grad_norm, every parameter, BatchNorm
     statistic, AdamW moment and step count, bit for bit; each step graph's
     hand-written kernel nodes (K1 34 / dx 18 / dw 18, K2 or K4 fwd+res 34 /
     dk,dv 18 / dq 18); the valid step graph against eager with its graphs'
     nodes; capture seconds, the pools' GiB, the replay's and the eager
     step's wall and device time; then the same bit-for-bit check under
     each other remat policy, with accumulation 2 and a frozen projection,
     in a one-process NCCL group and for the discrete task. The train
     phases above run under the same default dispatch: a replayed step's
     launches are held as its graph's kernel nodes;
  6. what users bring: ``quantize: int8`` (one cuBLASLt int8 product held
     bit for bit against int64 and timed against bf16; the infer path as in
     4 for the default configuration in bf16 and f32 and the opt-in one in
     bf16, whose graphs hold no K3; notes also against the unquantized
     engine; resident weight bytes); ``mel_method: dft`` (its log-mel
     against rfft on the card, and at every bin against an f64 log-mel no
     farther than the CPU's dft; the spectrum's times with its products in
     f32 and in f64, beside cuFFT's; notes, the mels' device time);
     the engine's
     oversize split (frame buckets cut at 256; 2 layers) graph vs eager; the discrete
     model (configs/discrete.yaml, 129 classes) through the infer CLI and
     ``Trainer.fit`` in bf16 with launch counts per step; a reference
     Lightning checkpoint (tests/torch_oracle.py's ``OracleModel`` at
     production width, 2 layers) through ``load_engine``, its f32 forward against
     ``OracleModel``'s;
  6b. the serving surfaces in default bf16 (``surfaces``), each from launch
     counts at 0: the host's split of a warm file pass per song (WAV
     decode, slicing with the Python and the native scan, wire encoding,
     MIDI write; the native FIR against its plain version); the port's
     ``serve.make_server`` on 127.0.0.1:0 answering 8 concurrent requests
     (notes against the direct engine, /healthz, /stats); ``batch_infer``
     over a DiffSinger-style set made from the songs; ``python -m
     some_tpu_torch.stream`` fed song 0 in 100 ms chunks (first-event
     latency, its MIDI against the offline path byte for byte); requires
     the native host plane (some_tpu_torch/native) built and called;
  6b'. the serving mesh (``mesh``, the CLIs' ``--devices N``), in default
     bf16 on the infer phase's checkpoint and songs: two engine replicas on
     cuda:0 (and cuda:0 + cuda:1 through ``load_engine(devices=2)`` where
     two cards exist), each from launch counts at 0: prewarm of the songs'
     shard buckets (graphs per replica; launches 2 x per forward x graphs x
     replicas), a file pass (note F1 >= 0.95 against one engine), warm RTF
     beside the one engine on the same card (recorded, not gated), peak
     reserved GiB per replica, an eager bucket run (K1 36 / K2 36), each
     replica's graphs' kernel nodes (K1 18 / K2 18); one bucket in 32-true,
     notes equal to one engine's; on two cards, every kernel on cuda:1 with
     device 0 current against its plain version;
  6c. preprocessing (``binarize``): RMVPE at the published geometry on
     seeded random weights saved as an upstream ``model.pt``, one packed
     8-row chunk of 5-60 s songs on the card and two songs against the CPU
     (probabilities, f0, voicing); the binarizer (``pe: rmvpe``, mel units,
     key shifts) over 16 songs on the card and on the CPU, item for item,
     with the ``bench_binarize`` line of the card's pass, then two train
     steps of the default model on the card's items; ContentVec at full
     HuBERT-base width, card against CPU and padded against unpadded;
  6d. export (``export``), from the default bf16 checkpoint at production
     width cut to its first 2 dual-stream layers: bucket 512 exported on the
     card as a ``torch.export`` program
     (``some_tpu_torch.deployment.export``), loaded and run twice on a 5.5 s
     song from launch counts at 0 (K1 6 and K2 6 a forward; the opt-in
     configuration K1 6, K3 12 and K4 6), against the exporter's engine
     under eager dispatch; the ONNX bridge's graph of the same weights
     (traced on the CPU) read by the port's ``onnx_inspect`` and executed by
     its numpy ``onnx_run`` on 3 s of the song against the eager ONNX
     module; torch's version and the artifacts' sizes;
  7. the engine in default bf16: a prewarm of every bucket up to 4096
     frames at rows 1-8 (its seconds and memory), and the infer CLI's cold
     case, a fresh process's ``load_engine`` + ``transcribe_file``, under
     the default dispatch, eager dispatch and capture on first use (one
     process each);
  8. the port's bench (``some_tpu_torch.bench``), shortened.
Each phase's seconds are printed, and the total; each log line starts
with the seconds since the script started. A seeded initialization of the
port is drawn once and loaded by later inits of the same shapes
(``cache_inits``).
Prints the train_rest phase's JSON line, the bench's, one JSON line of
kernel measurements, one of path results and, last, ``{"ok": true,
"device": {...}}``. Imports nothing
of JAX.

Every kernel row's ``ms`` and ``library_ms`` is one call's CUDA-event time,
host work included where the card waits for it. K1's rows add the card's
time alone (``device_ms``, ``library_device_ms``: the durations of a call's
kernels, from torch.profiler) and the wrapper's host time (``host_ms``).
"""
import contextlib
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
# the dual-stream layers the paths that check the same at any depth keep
# (cut_depth): export, oversize_split, lightning, the accumulation check
SHALLOW_LAYERS = 2


def log(*args):
    """A line of the run's log, after the seconds since the script started."""
    print(f"[{time.perf_counter() - START:7.1f} s]", *args, flush=True)


def cache_inits():
    """Draw each seeded initialization of the port (``nn/init.init_model``,
    which the tasks' ``init_state`` runs) once in this process: a later
    init of the same parameter shapes, seed and options loads the first
    one's weights (seconds a production-width model on the host)."""
    from some_tpu_torch.training import base_task

    plain, cache = base_task.init_model, {}

    def init_model(model, seed, remat=True, torch_style=True):
        key = (tuple((k, tuple(v.shape)) for k, v in model.state_dict().items()), seed, remat,
               torch_style)
        if key in cache:
            model.load_state_dict(cache[key])
        else:
            plain(model, seed, remat=remat, torch_style=torch_style)
            cache[key] = {k: v.detach().clone() for k, v in model.state_dict().items()}

    base_task.init_model = init_model


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
    from concurrent.futures import ThreadPoolExecutor

    cuobjdump = str(pathlib.Path(nvcc).parent / "cuobjdump")

    def sass_of(lib):
        return subprocess.run([cuobjdump, "-sass", str(libs[lib])], capture_output=True,
                              text=True, check=True).stdout

    counts = {}
    names = sorted({lib for lib, _, _ in TENSOR_CORE_KERNELS})
    with ThreadPoolExecutor(len(names)) as pool:  # one cuobjdump a library, all at once
        listings = list(pool.map(sass_of, names))
    for sass in listings:
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


def pow2(torch, like, exponent):
    """``2 ** exponent`` (an int tensor) in float32 on ``like``'s device,
    with that device current: ``torch.ldexp`` of tensors on ``cuda:1`` made
    with device 0 current faulted with an illegal memory access on device 0
    (PyTorch 2.11.0+cu128, two H100s; ``tools/torch_mesh_probe.py``)."""
    guard = torch.cuda.device(like.device) if like.is_cuda else contextlib.nullcontext()
    with guard:
        return torch.ldexp(torch.ones_like(like, dtype=torch.float32), exponent)


def bf16_ulp(torch, ref):
    """Spacing of bfloat16 numbers at each |ref| (8 significant bits)."""
    _, exponent = torch.frexp(ref.float().abs())
    return pow2(torch, ref, exponent - 8)


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
    ulp = torch.where(w == 0, 0.0, pow2(torch, w, exponent - bits))
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
                 ("depthwise_dw", "depthwise_conv1d_dw"), ("depthwise_fwd", "depthwise_conv1d"),
                 ("replica_max", "replica_max"))

# int8 sites of one forward of the production model (8 dual-stream layers):
# 18 conformer blocks x 8 and 8 layers x 2 GLU gates, one exchange each on a mesh
INT8_SITES = 160
# a lone replica of a group of two, in a process of its own: its exchange
# kernel finds no peer, traps past the bound (argv[2] s), and synchronize raises
LONE_REPLICA = """
import os, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from some_tpu_torch.ops.replica_max import ReplicaGroup, replica_max
group = ReplicaGroup(["cuda:0", "cuda:0"], bound_s=float(sys.argv[2]))
amax = torch.ones((), device="cuda")
torch.cuda.synchronize()
t0 = time.perf_counter()
replica_max(amax, group.members[0])
try:
    torch.cuda.synchronize()
except RuntimeError as exc:
    print(f"raised after {time.perf_counter() - t0:.3f} s: {str(exc).splitlines()[0]}", flush=True)
    os._exit(0)  # the context is lost: no teardown of it at exit
print("the lone exchange returned", flush=True)
os._exit(1)
"""


def lone_replica_traps(bound_s: float = 1.0, limit_s: float = 120.0) -> dict:
    """``LONE_REPLICA`` in a child process: it must raise (the kernel's
    trap) after at least ``bound_s`` and end within ``limit_s``."""
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-c", LONE_REPLICA, str(REPO), str(bound_s)],
                           capture_output=True, text=True, timeout=limit_s)
    wall = time.perf_counter() - t0
    said = child.stdout.strip().splitlines()
    if child.returncode != 0 or not said or not said[-1].startswith("raised after"):
        raise AssertionError(f"a lone replica's exchange did not fail in its bound: exit "
                             f"{child.returncode}, stdout {child.stdout[-2000:]!r}, stderr "
                             f"{child.stderr[-2000:]!r}")
    raised_s = float(said[-1].split()[2])
    if raised_s < bound_s:
        raise AssertionError(f"a lone replica's exchange raised after {raised_s} s, before its "
                             f"bound {bound_s} s")
    return {"bound_s": bound_s, "raised_after_s": raised_s, "child_wall_s": wall,
            "said": said[-1], "kernel_printed": "replica_max: replica 0 of 2" in child.stdout}


def check_replica_max(torch, sites: int = INT8_SITES, replays: int = 3,
                      devices=("cuda:0", "cuda:0")) -> dict:
    """The exchange kernel (csrc/replica_max.cu) against its plain version
    (``replica_max_plain``) on two replicas on ``devices`` (two of
    ``cuda:0`` by default; ``cuda:0`` and ``cuda:1`` across the host link),
    each on a stream of its own: ``sites`` exchanges of random amaxes
    eagerly, then each replica's ``sites`` exchanges captured in a CUDA
    graph and the two graphs replayed ``replays`` times with new amaxes,
    every output of every replica bit for bit the plain max (``max_abs_diff``
    is the largest difference seen). Between the two replicas' eager
    launches of one round the host also allocates a fresh block on the card
    (after ``empty_cache``) and a pinned one, which must not wait for the
    first replica's spinning exchange. Times (CUDA events): the two
    replicas' graph replays over ``sites`` (ms an exchange); the bound, the
    same replays of the exchange's bare traffic (``replica_max_touch``: its
    store and loads with no wait): the bytes it must move, at the rate the
    host link gives single words, which the HBM rate does not bound; the plain
    version on one pair. No single PyTorch call exchanges between two
    streams' work, so ``library_ms`` is None. Returns the kernel's row."""
    from some_tpu_torch.ops.replica_max import (
        ReplicaGroup, launching, replica_max_plain, replica_max_touch, replica_stream, slot_table,
    )

    devs = [torch.device(d) for d in devices]
    torch.cuda.set_device(0)
    group = ReplicaGroup(devs)
    streams = [replica_stream(d) for d in devs]
    gen = torch.Generator().manual_seed(16)
    amax = [torch.empty(sites, device=d) for d in devs]
    currents = {d: torch.cuda.current_stream(d) for d in set(devs)}
    current = torch.cuda.current_stream(devs[0])
    worst = [0.0]

    def fill():
        for a in amax:
            # exponential draws, a few exact zeros: the scale's clamp case
            a.copy_(torch.empty(sites).exponential_(0.3, generator=gen)
                    * (torch.rand(sites, generator=gen) > 0.05))
        for s, d in zip(streams, devs):
            s.wait_stream(currents[d])

    def exchanges(r, member=None):
        member = member or group.members[r]
        with torch.cuda.device(devs[r]), torch.cuda.stream(streams[r]):
            return torch.stack([member.max(amax[r][i]) for i in range(sites)])

    def join():
        for s in streams:
            current.wait_stream(s)

    def held(outs, label):
        pairs = [a.cpu() for a in amax]
        want = torch.stack([replica_max_plain([pairs[0][i], pairs[1][i]]) for i in range(sites)])
        for r, out in enumerate(outs):
            out = out.cpu()
            worst[0] = max(worst[0], float((out - want).abs().max()))
            if not torch.equal(out, want):
                raise AssertionError(f"replica_max {label}: replica {r} differs from the plain "
                                     f"max at {int((out != want).sum())} of {sites} sites")

    fill()
    # each replica's work once against a group of one first: a kernel's first
    # launch in a process loads its module (CUDA's lazy loading), which may
    # wait for the card, and so for a peer's spinning exchange
    for r, member in enumerate(group.members):
        with member.run_alone():
            exchanges(r)
    for d in set(devs):
        torch.cuda.synchronize(d)
    torch.cuda.empty_cache()
    with launching():
        outs = [exchanges(0)]
        # replica 0's first exchange now waits on the card for replica 1's
        fresh = torch.empty(3 * 2 ** 28 // 4 + 4099, device=devs[0])
        pinned = torch.empty(100 * 2 ** 20 // 4 + 811).pin_memory()
        outs.append(exchanges(1))
    join()
    torch.cuda.synchronize(devs[1])
    held(outs, "eager")
    del fresh, pinned
    graphs, static = [], []
    for r in range(2):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(devs[r]), torch.cuda.graph(graph, stream=streams[r]):
            static.append(exchanges(r))
        graphs.append(graph)

    def replay_all(gs):
        with launching():
            for r, graph in enumerate(gs):
                with torch.cuda.device(devs[r]), torch.cuda.stream(streams[r]):
                    graph.replay()
        join()

    for _ in range(replays):
        fill()
        replay_all(graphs)
        torch.cuda.synchronize(devs[1])
        torch.cuda.synchronize(devs[0])
        held(static, "graph replay")
    fill()
    round_ms = median_ms(torch, lambda: replay_all(graphs), reps=10, warmup=2)
    # the bound: each replica's bare store and loads, as many, replayed alike
    table = slot_table(2 * len(devs))
    touches = []
    for r in range(2):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(devs[r]), torch.cuda.graph(graph, stream=streams[r]):
            sink = torch.empty(sites, device=devs[r])
            for i in range(sites):
                replica_max_touch(table, len(devs), r, sink[i])
        touches.append(graph)
    bound_round_ms = median_ms(torch, lambda: replay_all(touches), reps=10, warmup=2)
    pair = [amax[0][0], amax[1][0].to(devs[0])]
    plain_ms = median_ms(torch, lambda: replica_max_plain(pair))
    label = "+".join(devices)
    row = {"shape": [2, sites], "dtype": "float32", "devices": list(devices),
           "max_abs_diff": worst[0], "kernel_ms": round_ms / sites, "plain_ms": plain_ms,
           "library_ms": None, "bound_ms": bound_round_ms / sites, "bound_by": "bytes",
           "bound_note": "the bytes an exchange must move across the host link (one store, "
                         "one load a replica) at the link's measured rate for single words: "
                         "replica_max_touch's replays",
           "replays": replays, "graph_round_ms": round_ms, "bound_round_ms": bound_round_ms,
           "library": "none: no PyTorch call exchanges between two replicas' streams"}
    log(f"replica_max: {sites} exchanges x 2 replicas of {label} bit for bit with the plain max "
        f"(eager with a fresh card and pinned allocation between the replicas' launches, then "
        f"{replays} graph replays); {row['kernel_ms'] * 1e3:.2f} us an exchange ({round_ms:.3f} "
        f"ms a round of {sites}), bound (the bare store and loads) "
        f"{row['bound_ms'] * 1e3:.2f} us, plain {plain_ms:.4f} ms")
    del graphs, static, touches
    return row


def profile_pass(torch, run):
    """Device time of one warm pass by kernel, from torch.profiler's CUDA
    activity alone: the kernels' records are all this reads, and recording
    every host op as well cost seconds a pass (as it does a remat policy's
    step, which ``remat_policies`` times under CUDA activity alone too). The
    profiler's own overhead is inside ``wall_s``: the busy share
    that counts divides ``device_ms`` by an unprofiled pass's wall time (the
    caller's)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    (``CUDAGraph(keep_graph=True)``) and its kernel nodes read through the
    CUDA driver (``utils/profiling.graph_kernel_nodes``); the engine's own
    graph for the bucket is put back after. The bucket runs on the engine's
    own device alone, so a mesh's replica (its first one included) shows its
    own graph of a shard."""
    from some_tpu_torch.utils import profiling

    class KeptGraph(torch.cuda.CUDAGraph):
        def __new__(cls, keep_graph=False):
            return super().__new__(cls, True)

        def __init__(self, keep_graph=False):
            super().__init__(True)

    key = (engine.wire, *mask.shape)
    saved = engine._graphs.pop(key, None)
    plain_graph, torch.cuda.CUDAGraph = torch.cuda.CUDAGraph, KeptGraph
    try:
        engine._run(*engine._stage(audio, mask), frames=False, capture=False)
    finally:
        torch.cuda.CUDAGraph = plain_graph
    kept = engine._graphs.pop(key)
    if saved is not None:
        engine._graphs[key] = saved
    counts = {}
    with torch.cuda.device(engine.device):
        for segment in kept.graphs:
            for name, n in profiling.graph_kernel_nodes(segment).items():
                counts[name] = counts.get(name, 0) + n
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


def model_dir(workdir: pathlib.Path, setup: dict, tag: str, precision: str, opt_in: bool,
              quantize: bool) -> pathlib.Path:
    """``workdir/<tag>-<precision>/``: the infer set-up's config in that
    precision (with the opt-in keys, with ``quantize: int8``) beside a link
    to its checkpoint. Returns the checkpoint's path there."""
    from some_tpu_torch.config import save_yaml

    d = workdir / f"{tag}-{precision}"
    d.mkdir()
    save_yaml(dict(setup["config"], pl_trainer_precision=precision,
                   **(OPT_IN if opt_in else {}), **({"quantize": "int8"} if quantize else {})),
              d / "config.yaml")
    os.symlink(setup["ckpt"], d / "model.pt")
    return d / "model.pt"


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

    The eager and plain engines take the graph engine's weights, so the
    checkpoint is read (and, under int8, quantized) once a precision.

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
        dirs[precision] = model_dir(workdir, setup, tag, precision, opt_in, quantize)

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
        t0 = time.perf_counter()
        graph = load_engine(dirs[precision], device="cuda", quiet=True)
        load_s = time.perf_counter() - t0
        # the eager and plain engines take the graph engine's weights (int8
        # ones quantized already) instead of reading, and quantizing, the
        # checkpoint again
        weights = graph.model.state_dict()
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
        log(f"{tag} {precision} graph path: load_engine {load_s:.2f} s; prewarm {n_prewarm} "
            f"graphs of buckets "
            f"{setup['buckets']} in {prewarm_s:.2f} s, {graph_gib:.2f} GiB reserved "
            f"({graph_held_gib:.2f} GiB after empty_cache); first "
            f"pass {graph.forwards - n_prewarm} replays, launches "
            f"{ {n: c for n, c in graph_launched.items() if c} } (captures only)")

        reset_counts()
        eager = load_engine(dirs[precision], device="cuda", quiet=True, state_dict=weights)
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
        if quantize and not opt_in and precision == "bf16":
            # the mesh phase's one int8 engine: loaded, quantized and prewarmed once
            set_dispatch(graph, "graph")
            setup["int8_engine"] = graph
        del graph, eager
        torch.cuda.empty_cache()

        plain = load_engine(dirs[precision], device="cuda", quiet=True, state_dict=weights)
        del weights
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
            "audio_s": audio_s, "load_s": load_s, "prewarm_graphs": n_prewarm,
            "prewarm_s": prewarm_s,
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
    from some_tpu_torch.ops.replica_max import replica_max

    return {"depthwise_conv1d": W.depthwise_conv1d, "depthwise_conv1d_dx": W.depthwise_conv1d_dx,
            "depthwise_conv1d_dw": W.depthwise_conv1d_dw, "flash_attention": A.flash_attention,
            "flash_attention_fwd_res": A.flash_attention_fwd_res,
            "flash_attention_bwd_dkv": A.flash_attention_bwd_dkv,
            "flash_attention_bwd_dq": A.flash_attention_bwd_dq,
            "fused_ln_ffn_residual": K3.fused_ln_ffn_residual,
            "splash_attention": A.splash_attention,
            "splash_attention_fwd_res": A.splash_attention_fwd_res,
            "splash_attention_bwd_dkv": A.splash_attention_bwd_dkv,
            "splash_attention_bwd_dq": A.splash_attention_bwd_dq,
            "replica_max": replica_max}


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
        ulp = torch.where(x == 0, 0.0, pow2(torch, x, exponent - 8))
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


def variants_launched(fn) -> dict:
    """The kernel variants ``fn()`` launches, by name, from the libraries'
    own launch tables (``csrc/launch_counts.cuh``), read before and after
    it: torch.profiler loses records of short runs and of graph replays,
    the tables do not."""
    from some_tpu_torch.ops import _build

    before = _build.variant_launches()
    fn()
    after = _build.variant_launches()
    return {name: n - before.get(name, 0) for name, n in after.items()
            if n != before.get(name, 0)}


def check_routes(torch) -> dict:
    """Each wrapper of TENSOR_CORE_KERNELS launches its tensor-core variant
    once for bf16 inputs and its CUDA-core variant (true f32) once for f32
    inputs, and no other variant, read from the launch tables. Inputs are
    small: [2, 8, 130, 64] attention, [2, 70, 512] rows for K3."""
    from some_tpu_torch.ops import attention as A
    from some_tpu_torch.ops import fused_ffn as K3

    gen = torch.Generator(device="cuda").manual_seed(5)
    routes = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (torch.randn((2, 8, 130, 64), generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        mask = torch.ones((2, 130), dtype=torch.bool, device="cuda")
        mask[1, 90:] = False
        out, stats = A.flash_attention_fwd_res(q, k, v, mask, 0.125)
        delta = (do.float() * out.float()).sum(-1).contiguous()
        lse = A.splash_attention_fwd_res(q, k, v, mask)[1]
        x = torch.randn((2, 70, 512), generator=gen, device="cuda").to(dtype)
        ln = [torch.ones(512, device="cuda"), torch.zeros(512, device="cuda"),
              torch.randn((512, 2048), generator=gen, device="cuda") / 512,
              torch.zeros(2048, device="cuda"),
              torch.randn((2048, 512), generator=gen, device="cuda") / 2048,
              torch.zeros(512, device="cuda")]
        calls = {
            "flash_attention": lambda: A.flash_attention(q, k, v, mask, 0.125),
            "flash_attention_fwd_res": lambda: A.flash_attention_fwd_res(q, k, v, mask, 0.125),
            "flash_attention_bwd_dkv": lambda: A.flash_attention_bwd_dkv(
                q, k, v, do, stats, delta, mask, 0.125),
            "flash_attention_bwd_dq": lambda: A.flash_attention_bwd_dq(
                q, k, v, do, stats, delta, mask, 0.125),
            "splash_attention": lambda: A.splash_attention(q, k, v, mask, 0.125),
            "splash_attention_fwd_res": lambda: A.splash_attention_fwd_res(q, k, v, mask),
            "splash_attention_bwd_dkv": lambda: A.splash_attention_bwd_dkv(
                q, k, v, do, lse, delta, mask),
            "splash_attention_bwd_dq": lambda: A.splash_attention_bwd_dq(
                q, k, v, do, lse, delta, mask),
            "fused_ln_ffn_residual": lambda: K3.fused_ln_ffn_residual(x, *ln)}
        for _, kernel, name in TENSOR_CORE_KERNELS:
            with torch.no_grad():
                launched = variants_launched(calls[name])
            want = kernel if dtype == torch.bfloat16 else kernel.replace("_mma", "")
            if launched != {want: 1}:
                raise AssertionError(f"{name} {dtype}: launched variants {launched}, want "
                                     f"{ {want: 1} }")
            routes[f"{name} {str(dtype)[6:]}"] = want
    log("variant routes (launch tables): " + json.dumps(routes))
    return routes


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
    def load_datasets():
        sizes = lambda items: np.array([i["length"] for i in items])
        return (train_items, sizes(train_items)), (valid_items, sizes(valid_items))

    task = recording_task(config, device)
    task.load_datasets = load_datasets
    return task


def recording_task(config, device="cuda"):
    """The port's task of ``config`` (``train.TASKS``), whose train steps
    keep their seconds, losses, launches, dispatch ('eager', 'capture' or
    'replay') and, for a replay, its graph's hand-written kernel nodes
    (``step_records``), and whose validation forwards the same
    (``valid_launches``: launches, ``valid_dispatch``: (dispatch, nodes))."""
    from some_tpu_torch.train import TASKS
    from some_tpu_torch.utils.profiling import hand_written_nodes

    class RecordingTask(TASKS[config["task_cls"]]):
        def replay_nodes(self, training):
            """A replay's graph nodes (counted once a graph), else None."""
            if self.last_dispatch != "replay":
                return None
            entry = self.last_graph
            if id(entry) not in self.nodes:
                self.nodes[id(entry)] = (entry, hand_written_nodes(entry.graph, training))
            return self.nodes[id(entry)][1]

        def valid_step(self, state, batch):
            before = read_counts()
            out = super().valid_step(state, batch)
            after = read_counts()
            self.valid_launches.append({n: after[n] - before[n] for n in after})
            self.valid_dispatch.append((self.last_dispatch, self.replay_nodes(False)))
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
                "launches": {n: after[n] - before[n] for n in after},
                "dispatch": self.last_dispatch, "graph_nodes": self.replay_nodes(True)})
            return logs

    task = RecordingTask(config, device=device)
    task.step_records = []
    task.valid_launches = []
    task.valid_dispatch = []
    task.nodes = {}
    return task


def check_step_launches(label, launches, dispatch, nodes, want):
    """An eager or capturing step launches ``want`` (a replay calls no
    wrapper) and a replay's graph holds ``want`` as kernel nodes."""
    if dispatch == "replay":
        if any(launches.values()) or nodes != {n: c for n, c in want.items() if c}:
            raise AssertionError(f"{label}: a replay launched {launches} from a graph of "
                                 f"hand-written kernel nodes {nodes}, want {want}")
    elif launches != want:
        raise AssertionError(f"{label} ({dispatch}) launched {launches}, want {want}")


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
    Launches are held per train step and per validation forward, a replay's
    as its graph's kernel nodes (the default dispatch: a bucket's second
    visit captures its step, later visits replay it). ``opt_in``
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
        check_step_launches(f"{tag} train step {i}", rec["launches"], rec["dispatch"],
                            rec["graph_nodes"], want)
    if not task.valid_launches:
        raise AssertionError(f"{tag}: no validation forward")
    for launches_v, (dispatch, nodes) in zip(task.valid_launches, task.valid_dispatch):
        check_step_launches(f"{tag} validation forward", launches_v, dispatch, nodes,
                            want_valid)
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
        f"{len(task.valid_launches)} (a replay's as its graph's nodes); dispatch "
        f"{[r['dispatch'] for r in records]}; warm step median {step_ms:.1f} ms (synchronized per "
        f"step), {frames_per_s:.0f} frames/s; peak {peak_gib:.2f} GiB; losses "
        f"{[round(x, 4) for x in losses]}; validation {trainer.last_validation}")

    # device busy share of one more step on the largest bucket, against the
    # unprofiled wall of the same step; two steps first, so its graph is
    # captured and the timed steps replay it
    big = max(range(len(train_items) // 8), key=lambda i: max(
        train_items[j]["length"] for j in range(8 * i, 8 * i + 8)))
    batch = task.to_device(task.collate(train_items[8 * big: 8 * big + 8]))
    task.train_step(state, batch)
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
    profiled["dispatch"] = task.last_dispatch
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
    import copy

    from some_tpu_torch.nn.conformer import set_kernel_impl
    from some_tpu_torch.training.base_task import TrainState

    tag = "opt-in" if opt_in else "default"
    items = synthetic_items(9, 4, 80, lo=900, hi=1100)
    result = {}
    for precision, rel_log, rel_grad in (("32-true", 1e-4, 1e-3), ("bf16", 2e-2, 0.1)):
        config = production_config(pl_trainer_precision=precision,
                                   **(OPT_IN if opt_in else {}))
        config["midi_extractor_args"] = dict(config["midi_extractor_args"], conv_drop=0.0,
                                             ffn_latent_drop=0.0, ffn_out_drop=0.0,
                                             attention_drop=0.0)
        runs, start = {}, None
        for impl in ("kernel", "plain"):
            task = in_memory_task(config, items, items)
            if start is None:  # the plain run takes a copy of the kernel run's start
                state = task.init_state(seed=11)
                start = copy.deepcopy(state.model)
            else:
                state = TrainState(start, None)
            set_kernel_impl(state.model, "auto" if impl == "kernel" else impl)
            batch = task.collate(items)
            reset_counts()
            runs[impl] = step_grads(torch, task, state, batch)
            counts = read_counts()
            if (impl == "plain") == any(counts.values()):
                raise AssertionError(f"{tag} {precision} {impl} path launches {counts}")
            del task, state
        del start
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


# ---- training, the rest: accumulation, resume and frozen parameters on the
# card, finetuning, every remat policy, the profile window, world size 1 ----

def train_step_launches(config, names) -> dict:
    """The hand-written kernels' launches in one train step of ``config``
    (any remat policy): K1's forward and K2's (K4's) forward with residuals
    once a block and again in each remat'd block's recompute, each backward
    kernel once a block."""
    lay = config["midi_extractor_args"]["lay"]
    blocks, remat_blocks = 2 * lay + 2, (2 * lay if config.get("use_remat", True) else 0)
    attn = "splash_attention" if config.get("attention_impl") == "splash" else "flash_attention"
    per_step = {"depthwise_conv1d": blocks + remat_blocks, "depthwise_conv1d_dx": blocks,
                "depthwise_conv1d_dw": blocks, f"{attn}_fwd_res": blocks + remat_blocks,
                f"{attn}_bwd_dkv": blocks, f"{attn}_bwd_dq": blocks}
    return {name: per_step.get(name, 0) for name in names}


def remat_policies(torch, rows=8, frames=2048):
    """One forward and backward of each remat policy from one state and one
    batch (``rows`` x ``frames``, bf16, dropout 0.1 keyed to (seed, step)):
    the four policies in the default configuration, ``nothing`` and
    ``save_attn_conv`` in the opt-in one. A policy changes what the forward
    keeps, not the arithmetic, so the loss and every gradient equal
    ``nothing``'s bit for bit (the recompute draws the same dropout masks
    and leaves the BatchNorm statistics alone). The K1 and K2 (K4) launches
    of the step are held to PERF.md's counts: every policy runs the kernels'
    forwards again in the recompute (none keeps a hand-written kernel's
    output, and the BatchNorm after K1 and K2's own backward need them), so
    K1 34 / dx 18 / dw 18 and K2 (K4) fwd+res 34 / dk,dv 18 / dq 18, as
    under ``nothing``. Per policy: peak memory (max_memory_allocated) and
    launches of the first run; the synchronized wall time and the device
    time (the kernels' durations) of a second, under torch.profiler with
    the CUDA activity alone (the CPU activity's bookkeeping of every op
    would take seconds a step and enter the wall)."""
    from torch.profiler import ProfilerActivity, profile

    from some_tpu_torch.nn.conformer import REMAT_POLICIES
    from some_tpu_torch.training.base_task import TrainState

    items = synthetic_items(12, rows, 80, lo=frames - 100, hi=frames)
    cases = [(False, p) for p in REMAT_POLICIES] + [(True, "nothing"), (True, "save_attn_conv")]
    result, start, refs = {}, {}, {}
    for opt_in, policy in cases:
        tag = f"{'opt_in' if opt_in else 'default'}/{policy}"
        t_case = time.perf_counter()
        config = production_config(remat_policy=policy, **(OPT_IN if opt_in else {}))
        task = in_memory_task(config, items, items)
        if opt_in not in start:  # one start per configuration: the first policy's
            state = task.init_state(seed=11)
            start[opt_in] = {k: v.clone() for k, v in state.model.state_dict().items()}
        else:  # the same weights without drawing them again
            state = TrainState(task.build_model().to(task.device), None)
            state.model.load_state_dict(start[opt_in])
        batch = task.collate(items)
        if tuple(batch["units"].shape[:2]) != (rows, frames):
            raise AssertionError(f"remat batch {batch['units'].shape}, want {rows} x {frames}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = read_counts()
        logs, grads = step_grads(torch, task, state, batch)
        torch.cuda.synchronize()
        after = read_counts()
        counts = {n: after[n] - before[n] for n in after}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step_grads(torch, task, state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        want = train_step_launches(config, counts)
        if counts != want:
            raise AssertionError(f"remat {tag}: launched {counts}, want {want}")
        entry = {"loss": logs["total_loss"], "grad_norm": logs["grad_norm"],
                 "peak_gib": peak, "step_wall_ms": wall_ms, "device_ms": device_ms,
                 "launches": {n: c for n, c in counts.items() if c}}
        if policy == "nothing":
            refs[opt_in] = (logs, grads)
        else:
            ref_logs, ref_grads = refs[opt_in]
            if logs["total_loss"] != ref_logs["total_loss"]:
                raise AssertionError(f"remat {tag}: loss {logs['total_loss']!r}, nothing's "
                                     f"{ref_logs['total_loss']!r}")
            differ = [n for n, g in ref_grads.items() if not torch.equal(grads[n], g)]
            if differ:
                worst = max(float((grads[n].float() - ref_grads[n].float()).abs().max())
                            for n in differ)
                raise AssertionError(f"remat {tag}: {len(differ)} of {len(grads)} gradients "
                                     f"differ from nothing's (max |d| {worst:.3e}), e.g. "
                                     f"{differ[:5]}")
            entry.update(grads_bitwise_equal=len(grads), grads=len(grads))
        entry["s"] = time.perf_counter() - t_case
        log(f"remat {tag}, {rows} x {frames} bf16: " + json.dumps(entry))
        result[tag] = entry
        del task, state, grads
        torch.cuda.empty_cache()
    del refs
    torch.cuda.empty_cache()
    return result


def state_diff(torch, got: dict, want: dict) -> dict:
    """How far two state_dicts are apart: max |d| and the count of tensors
    that differ."""
    diffs = [float((got[k].float() - v.float()).abs().max()) for k, v in want.items()]
    return {"max_abs": max(diffs), "tensors_differing": sum(d > 0 for d in diffs),
            "tensors": len(diffs)}


def interrupt_at(task, call: int):
    """Make ``task.train_step`` raise KeyboardInterrupt at its ``call``-th
    call, before it applies anything."""
    inner, calls = task.train_step, [0]

    def train_step(state, batch):
        calls[0] += 1
        if calls[0] == call:
            raise KeyboardInterrupt("chip_smoke: interrupted")
        return inner(state, batch)

    task.train_step = train_step


def accumulate_resume_frozen(torch, workdir: pathlib.Path, source: pathlib.Path, items):
    """Queue 3's open item on the card. From the default train phase's
    checkpoint cut to its first ``SHALLOW_LAYERS`` layers
    (``finetune_ckpt_path``), with ``accumulate_grad_batches: 2``
    and ``model.backbone.in_proj_midi`` frozen: 6 micro-steps (3 updates)
    straight through; then 3, an interrupt (the accumulator half full), and
    a resume to 6, which captures its step graphs again. The resumed run
    equals the straight one bit for bit (a step is deterministic: two
    straight runs were equal bit for bit, so a second one is not made); the
    frozen projection keeps the file's values bit for bit in every run.
    Only the interrupt's checkpoint is written (the resume reads it); the
    runs' final weights are taken from memory."""
    from some_tpu_torch.training.trainer import Trainer
    from some_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    # the weights alone (a third of the file), cut to SHALLOW_LAYERS layers
    config, weights = cut_depth(production_config(), load_checkpoint(source)["state_dict"],
                                SHALLOW_LAYERS)
    source = save_checkpoint(workdir / "accumulate-source.ckpt", weights)
    frozen = {k: v for k, v in weights.items() if k.startswith("backbone.in_proj_midi.")}
    del weights
    config.update(accumulate_grad_batches=2, freezing_enabled=True,
                  frozen_params=["model.backbone.in_proj_midi"], finetune_enabled=True,
                  finetune_ckpt_path=str(source), val_check_interval=1000,
                  num_sanity_val_steps=0, log_interval=1000)
    def no_final_checkpoint(trainer):
        trainer._save_ckpt = lambda *args: None
        return trainer

    finals = {}
    for run in ("straight", "resumed"):
        work = workdir / f"accumulate-{run}"
        task = in_memory_task(config, items, items)
        if run == "resumed":
            interrupt_at(task, 4)
            try:
                Trainer(task, work).fit(max_steps=3)  # writes the interrupt's checkpoint
                raise AssertionError("the interrupt did not reach the trainer")
            except KeyboardInterrupt:
                pass
            meta = load_checkpoint(work / "model_ckpt_steps_1.ckpt")
            if meta["meta"]["micro_step"] != 3 or meta["accumulator"]["mini_step"] != 1:
                raise AssertionError(f"interrupt checkpoint {meta['meta']}, accumulator "
                                     f"{meta['accumulator'] and meta['accumulator']['mini_step']}")
            del meta
            task = in_memory_task(config, items, items)
        state = no_final_checkpoint(Trainer(task, work)).fit(max_steps=3)
        if state.step != 6 or state.accumulator is not None:
            raise AssertionError(f"{run}: micro-step {state.step}, accumulator "
                                 f"{state.accumulator is not None}")
        final = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
        for key, value in frozen.items():
            if not torch.equal(final[key], value):
                raise AssertionError(f"{run}: the frozen {key} moved")
        finals[run] = final
        del task, state
        torch.cuda.empty_cache()
    resumed = state_diff(torch, finals["resumed"], finals["straight"])
    log(f"accumulate 2 + frozen in_proj_midi, 6 micro-steps from the default checkpoint "
        f"cut to {SHALLOW_LAYERS} layers: "
        f"resumed at 3 vs straight: {resumed}")
    if resumed["max_abs"] != 0:
        raise AssertionError(f"the resumed run differs from the straight run: {resumed}")
    return {"resumed_vs_straight": resumed, "frozen_bitwise": True}, finals["straight"]


def validation_card_vs_cpu(torch, weights: dict, valid_items, lay: int | None = None):
    """One validation forward on the card; the validation outputs (the note
    decode's ``index_add_`` segment sums, the cumsum and its round, the
    midi_acc counters) and the losses computed from that forward's outputs
    on the card and on the CPU. Integer outputs must be equal; note values
    and losses within f32 rounding (|d| <= 1e-4 + 1e-6 |want| and rel 1e-5).
    ``lay``: the weights' dual-stream layers, if not the production 8."""
    config = production_config()
    if lay is not None:
        config["midi_extractor_args"] = dict(config["midi_extractor_args"], lay=lay)
    task = in_memory_task(config, valid_items, valid_items)
    state = task.init_state()
    state.model.load_state_dict(weights)
    batch = task.collate(valid_items)
    model = state.model.eval()
    card = task.to_device(batch)
    with torch.no_grad():
        outputs = model(**task.model_inputs(card))
        got = task.valid_outputs(outputs, card)
        got_losses = task.compute_losses(outputs, card)
    cpu_task = in_memory_task(config, valid_items, valid_items, device="cpu")
    host = cpu_task.to_device(batch)
    cpu_out = tuple(o.detach().cpu() for o in outputs)
    want = cpu_task.valid_outputs(cpu_out, host)
    want_losses = cpu_task.compute_losses(cpu_out, host)
    report = {"rows": int(batch["size"]), "frames": int(batch["units"].shape[1])}
    for key in ("midi_acc_correct", "midi_acc_total", "n_notes", "note_dur", "note_rest"):
        if not torch.equal(got[key].cpu(), want[key]):
            raise AssertionError(f"validation {key}: card {got[key].cpu()} CPU {want[key]}")
    report["midi_acc"] = [int(got["midi_acc_correct"]), int(got["midi_acc_total"])]
    report["notes"] = int(got["n_notes"].sum())
    for key in ("note_midi", "midi_pred", "probs", "bounds"):
        g, w = got[key].cpu().float(), want[key].float()
        finite = torch.isfinite(w)
        if not torch.equal(finite, torch.isfinite(g)):
            raise AssertionError(f"validation {key}: infinities differ")
        d = (g[finite] - w[finite]).abs()
        report[f"{key}_max_abs"] = float(d.max()) if d.numel() else 0.0
        if d.numel() and bool((d > 1e-4 + 1e-6 * w[finite].abs()).any()):
            raise AssertionError(f"validation {key}: card vs CPU max |d| {float(d.max())}")
    for key, value in want_losses.items():
        rel = abs(float(got_losses[key]) - float(value)) / abs(float(value))
        report[f"{key}_rel"] = rel
        if rel > 1e-5:
            raise AssertionError(f"validation {key}: card {float(got_losses[key])} CPU "
                                 f"{float(value)}")
    log("validation outputs, card vs CPU on one forward's outputs: " + json.dumps(report))
    del task, state, model, outputs
    torch.cuda.empty_cache()
    return report


def finetune_from_lightning(torch, workdir: pathlib.Path, items):
    """Finetune from a reference Lightning ``.ckpt`` at production width
    (tests/torch_oracle.py's OracleModel, random BatchNorm statistics, as
    lightning_check makes it) with ``finetune_ignored_params:
    [model.backbone.bound_head]``: every other leaf equals the file's bit
    for bit, the head keeps its fresh value; then two steps, with the K1 and
    K2 launches of a default train step."""
    sys.path.insert(0, str(REPO / "tests"))
    from torch_oracle import OracleModel

    from some_tpu_torch.compat.torch_ckpt import reference_state_dict
    from some_tpu_torch.training.trainer import Trainer

    config = production_config()
    args = config["midi_extractor_args"]
    torch.manual_seed(271828)
    oracle = OracleModel(args["lay"], args["dim"], config["units_dim"], config["midi_num_bins"],
                         kernel_size=args["kernel_size"], heads=args["attention_heads"],
                         dim_head=args["attention_heads_dim"])
    with torch.no_grad():
        for m in oracle.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0, 0.5)
                m.running_var.uniform_(0.5, 2.0)
    payload = {"state_dict": {f"model.{k}": v for k, v in oracle.state_dict().items()},
               "hyper_parameters": AttributeDict(config), "global_step": 0}
    path = workdir / "finetune-source.ckpt"
    torch.save(payload, path)
    file_sd = reference_state_dict(payload)
    del oracle, payload
    config.update(finetune_enabled=True, finetune_ckpt_path=str(path),
                  finetune_ignored_params=["model.backbone.bound_head"])
    task = in_memory_task(config, items, items)
    fresh = {k: v.cpu() for k, v in task.init_state().model.state_dict().items()
             if k.startswith("backbone.bound_head.")}
    work = workdir / "finetune"
    loaded = Trainer(task, work).restore_or_init()
    got = {k: v.cpu() for k, v in loaded.model.state_dict().items()}
    for key, value in got.items():
        want = fresh[key] if key.startswith("backbone.bound_head.") else file_sd[key]
        if not torch.equal(value, want):
            raise AssertionError(f"finetune: {key} is not the "
                                 f"{'fresh' if key in fresh else 'file'} value")
    del got
    for i in range(2):
        task.train_step(loaded, task.collate(items[8 * i: 8 * i + 8]))
    per_step = [r["launches"] for r in task.step_records]
    want = train_step_launches(config, per_step[0])
    if loaded.step != 2 or any(c != want for c in per_step):
        raise AssertionError(f"finetune steps launched {per_step}, want {want} each")
    losses = [r["total_loss"] for r in task.step_records]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"finetune losses {losses}")
    log(f"finetune from a Lightning file ({len(file_sd)} leaves, bound_head ignored): every "
        f"other leaf equals the file's, the head its fresh value; 2 steps, losses {losses}, "
        f"launches per step {({n: c for n, c in want.items() if c})}")
    del task, loaded
    torch.cuda.empty_cache()
    return {"leaves": len(file_sd), "losses": losses, "launches_per_step": want}


def profile_window(torch, workdir: pathlib.Path, items):
    """``profile_dir`` with ``log_interval: 2``: 3 micro-steps are asked, so
    the trainer takes updates 1 and 2, the traced repeat of update 2's batch
    (counted as a step), and stops: 3 steps, 2 batches consumed (JAX's
    anchor rule). The trace file holds K1 and K2 kernel records, at least
    one of each (torch.profiler may drop records); the traced step, the
    batch's second visit, captures and replays its graph, whose hand-written
    kernel nodes the trainer writes beside the trace
    (``graph_kernel_nodes.json``): one train step's."""
    from some_tpu_torch.training.trainer import Trainer
    from some_tpu_torch.utils.checkpoint import load_checkpoint

    profile_dir = workdir / "profile"
    config = production_config(profile_dir=str(profile_dir), log_interval=2,
                               val_check_interval=1000, num_sanity_val_steps=0)
    task = in_memory_task(config, items, items)
    work = workdir / "profiled"
    state = Trainer(task, work).fit(max_steps=3)
    meta = load_checkpoint(work / "model_ckpt_steps_3.ckpt")["meta"]
    if state.step != 3 or meta["micro_step"] != 3 or meta["epoch_batch"] != 2:
        raise AssertionError(f"profile window: step {state.step}, checkpoint meta {meta}")
    traces = sorted(profile_dir.glob("*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"profile window wrote {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    groups = {}
    for name in kernels:
        group = next((g for key, g in KERNEL_GROUPS if key in name.lower()), None)
        if group:
            groups[group] = groups.get(group, 0) + 1
    k1 = sum(c for g, c in groups.items() if g.startswith("depthwise"))
    k2 = sum(c for g, c in groups.items() if g.startswith("flash"))
    log(f"profile window: {traces[0].name} ({traces[0].stat().st_size} bytes), "
        f"{len(kernels)} kernel records, hand-written by group {groups}; checkpoint meta "
        f"{ {k: meta[k] for k in ('micro_step', 'epoch', 'epoch_batch')} }")
    if not k1 or not k2:
        raise AssertionError(f"the trace holds no K1 or no K2 record: {groups}")
    nodes = json.loads((profile_dir / "graph_kernel_nodes.json").read_text())
    want = {n: c for n, c in train_step_launches(config, ALL_TRAIN_KERNELS).items() if c}
    log(f"profile window: the traced step's graph ({nodes['dispatch']}) holds {nodes['kernels']}")
    if nodes["dispatch"] not in ("capture", "replay") or nodes["kernels"] != want:
        raise AssertionError(f"profile window: graph_kernel_nodes.json {nodes}, want {want}")
    del task, state
    torch.cuda.empty_cache()
    return {"trace_bytes": traces[0].stat().st_size, "kernel_records": len(kernels),
            "hand_written_records": groups, "meta": meta, "graph_kernel_nodes": nodes}


def world_size_one(torch, items):
    """Two train steps in a one-process NCCL group joined through the
    SOME_TPU_COORDINATOR contract (the collectives of several processes:
    the losses' counts, BatchNorm's sums, the gradients), against the same
    two steps without a group: losses and every weight bit for bit."""
    import socket

    from some_tpu_torch.parallel import distributed as dist
    from some_tpu_torch.training.base_task import TrainState

    config = production_config()
    runs, backend, start = {}, None, None
    for grouped in (True, False):
        if grouped:
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            os.environ.update(SOME_TPU_COORDINATOR=f"127.0.0.1:{port}",
                              SOME_TPU_NUM_PROCESSES="1", SOME_TPU_PROCESS_ID="0")
        try:
            if grouped and not dist.maybe_initialize("cuda"):
                raise AssertionError("maybe_initialize did not join a group")
            if grouped:
                backend = torch.distributed.get_backend()
            task = in_memory_task(config, items, items)
            if grouped:
                state = task.init_state()
                start = {k: v.clone() for k, v in state.model.state_dict().items()}
            else:  # the same initial weights without drawing them again
                model = task.build_model().to(task.device)
                model.load_state_dict(start)
                state = TrainState(model, task.make_optimizer(model))
                del model, start
            for i in range(2):
                task.train_step(state, task.collate(items[8 * i: 8 * i + 8]))
            runs[grouped] = ([r["total_loss"] for r in task.step_records],
                             {k: v.detach().cpu().clone()
                              for k, v in state.model.state_dict().items()})
            del task, state
        finally:
            for name in ("SOME_TPU_COORDINATOR", "SOME_TPU_NUM_PROCESSES", "SOME_TPU_PROCESS_ID"):
                os.environ.pop(name, None)
            dist.destroy()
        torch.cuda.empty_cache()
    (losses_g, sd_g), (losses_p, sd_p) = runs[True], runs[False]
    diff = state_diff(torch, sd_g, sd_p)
    log(f"world size 1 over {backend}: losses {losses_g} vs {losses_p} without a group; "
        f"weights {diff}")
    if backend != "nccl" or losses_g != losses_p or diff["max_abs"] != 0:
        raise AssertionError(f"world size 1 ({backend}) differs from no group: {losses_g} vs "
                             f"{losses_p}, {diff}")
    return {"backend": backend, "losses": losses_g, "weights": diff}


def train_rest(torch, workdir: pathlib.Path):
    """Training, the rest, at production width in bf16 after the default
    train phase: (i) accumulation, resume and frozen parameters from that
    phase's checkpoint, and one validation's outputs on the card against
    the CPU; (ii) finetuning from a Lightning file; (iii) every remat
    policy; (iv) the profile window; (v) world size 1 over NCCL. The counts
    start at 0 with the phase and are read at its end; each check's
    launches and seconds are its own difference."""
    items = synthetic_items(7, 24, 80, lo=300, hi=700)  # three batches an epoch, T <= 768
    valid_items = synthetic_items(8, 8, 80)
    source = workdir / "train-default" / "model_ckpt_steps_8.ckpt"
    result, seconds, by_check = {}, {}, {}

    def check(name, fn, *args):
        before, t0 = read_counts(), time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        after = read_counts()
        by_check[name] = {n: after[n] - before[n] for n in after if after[n] != before[n]}
        log(f"train_rest {name}: {seconds[name]:.1f} s, launches {by_check[name]}")
        return out

    reset_counts()
    result["accumulate_resume_frozen"], weights = check(
        "accumulate_resume_frozen", accumulate_resume_frozen, torch, workdir, source, items)
    result["validation_card_vs_cpu"] = check("validation_card_vs_cpu", validation_card_vs_cpu,
                                             torch, weights, valid_items, SHALLOW_LAYERS)
    del weights
    result["finetune_lightning"] = check("finetune_lightning", finetune_from_lightning, torch,
                                         workdir, items)
    result["remat"] = check("remat", remat_policies, torch)
    result["profile_window"] = check("profile_window", profile_window, torch, workdir, items)
    result["world_size_one"] = check("world_size_one", world_size_one, torch, items)
    launched = read_counts()
    for name in ("depthwise_conv1d", "depthwise_conv1d_dx", "depthwise_conv1d_dw",
                 "flash_attention_fwd_res", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
                 "splash_attention_fwd_res", "splash_attention_bwd_dkv",
                 "splash_attention_bwd_dq"):
        if not launched[name]:
            raise AssertionError(f"train_rest never launched {name}: {launched}")
    result.update(s=seconds, launches_by_check=by_check)
    return result, launched


# ---- the compiled train and valid steps: graph dispatch against eager ----

ALL_TRAIN_KERNELS = ("depthwise_conv1d", "depthwise_conv1d_dx", "depthwise_conv1d_dw",
                     "flash_attention_fwd_res", "flash_attention_bwd_dkv",
                     "flash_attention_bwd_dq", "splash_attention_fwd_res",
                     "splash_attention_bwd_dkv", "splash_attention_bwd_dq")


def per_valid_forward(config) -> dict:
    """The hand-written kernels of one validation (eval-mode) forward."""
    blocks = 2 * config["midi_extractor_args"]["lay"] + 2
    if config.get("attention_impl") == "splash":
        out = {"depthwise_conv1d": blocks, "splash_attention": blocks}
        if config.get("fuse_ffn"):
            out["fused_ln_ffn_residual"] = 2 * blocks
        return out
    return {"depthwise_conv1d": blocks, "flash_attention": blocks}


def pool_gib(torch, pool) -> float:
    """GiB of the segments the caching allocator holds for a graph pool."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool)) / 2 ** 30


def graph_pair(torch, config, seed=11):
    """A task on the default (graph) dispatch and one on the test-only eager
    dispatch, each with a state of the same seeded weights (the eager one's
    model a copy of the other's, not built again)."""
    import copy

    from some_tpu_torch.train import TASKS
    from some_tpu_torch.training.base_task import TrainState, set_train_dispatch

    graph, eager = TASKS[config["task_cls"]](config), TASKS[config["task_cls"]](config)
    set_train_dispatch(eager, "eager")
    state_g = graph.init_state(seed=seed)
    model = copy.deepcopy(state_g.model)
    return graph, state_g, eager, TrainState(model, eager.make_optimizer(model))


def states_differ(torch, state_g, state_e) -> list:
    """Names of what two train states hold that is not equal bit for bit:
    parameters and BatchNorm statistics (``state_dict``), then AdamW's
    moments and step counts, the lr and the accumulator."""
    got = state_g.model.state_dict()
    out = [k for k, v in state_e.model.state_dict().items() if not torch.equal(got[k], v)]
    params = dict(state_e.model.named_parameters())
    names = {p: n for n, p in params.items()}
    got_params = dict(state_g.model.named_parameters())
    for p, st in state_e.optimizer.state.items():
        other = state_g.optimizer.state[got_params[names[p]]]
        out += [f"{names[p]}.{key}" for key, v in st.items() if not torch.equal(other[key], v)]
    if not torch.equal(state_g.lr, state_e.lr):
        out.append("lr")
    out += [f"acc.{k}" for k, v in (state_e.acc_grads or {}).items()
            if not torch.equal(state_g.acc_grads[k], v)]
    return out


def graph_vs_eager_steps(torch, label, graph, state_g, eager, state_e, batches):
    """Each batch through both tasks' train steps: the logs bit for bit at
    every step, then the states (``states_differ``); every step graph's
    hand-written kernel nodes equal one step's launches. Returns (dispatch
    kinds, each capture step's synchronized seconds, nodes per graph)."""
    from some_tpu_torch.utils.profiling import hand_written_nodes

    kinds, capture_s = [], {}
    for batch in batches:
        batch = graph.to_device(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs_g = graph.train_step(state_g, batch)
        torch.cuda.synchronize()
        kinds.append(graph.last_dispatch)
        if graph.last_dispatch == "capture":
            capture_s["x".join(map(str, batch["units"].shape[:2]))] = time.perf_counter() - t0
        logs_e = eager.train_step(state_e, batch)
        differ = [k for k in logs_e if not torch.equal(logs_g[k], logs_e[k])]
        if eager.last_dispatch != "eager" or differ:
            raise AssertionError(f"{label}: step {len(kinds)} ({kinds[-1]}) logs {differ} differ "
                                 f"from eager: {({k: float(logs_g[k]) for k in differ})} vs "
                                 f"{({k: float(logs_e[k]) for k in differ})}")
    differ = states_differ(torch, state_g, state_e)
    if differ:
        raise AssertionError(f"{label}: after {len(kinds)} steps {len(differ)} state tensors "
                             f"differ from eager, e.g. {differ[:6]}")
    want = {n: c for n, c in train_step_launches(graph.config, ALL_TRAIN_KERNELS).items() if c}
    nodes = []
    for key, entry in state_g.graphs.items():
        if key[0][0] != "train":
            continue
        got = hand_written_nodes(entry.graph, training=True)
        if got != want:
            raise AssertionError(f"{label}: the step graph of {key[0]} holds hand-written "
                                 f"kernel nodes {got}, want {want}")
        nodes.append(got)
    return kinds, capture_s, nodes


def graph_vs_eager_valid(torch, label, graph, state_g, eager, state_e, batches):
    """The valid step through both tasks from equal weights, each batch
    visited three times (eager, capture, replay): losses and outputs bit
    for bit (note_midi to f32 rounding: the decode's index_add_ is atomic);
    each valid graph's kernel nodes equal one eval forward's."""
    from some_tpu_torch.utils.profiling import hand_written_nodes

    kinds, worst = [], 0.0
    for batch in batches * 3:
        batch = graph.to_device(batch)
        (losses_g, extras_g), (losses_e, extras_e) = (graph.valid_step(state_g, batch),
                                                      eager.valid_step(state_e, batch))
        kinds.append(graph.last_dispatch)
        differ = [k for k in losses_e if not torch.equal(losses_g[k], losses_e[k])]
        differ += [k for k in extras_e if k != "note_midi"
                   and not torch.equal(extras_g[k], extras_e[k])]
        if differ:
            raise AssertionError(f"{label}: valid step {len(kinds)} ({kinds[-1]}) differs from "
                                 f"eager in {differ}")
        worst = max(worst, float((extras_g["note_midi"] - extras_e["note_midi"]).abs().max()))
    if worst > 1e-3:
        raise AssertionError(f"{label}: valid note_midi graph vs eager {worst}")
    want = per_valid_forward(graph.config)
    nodes = [hand_written_nodes(e.graph, training=False)
             for k, e in state_g.graphs.items() if k[0][0] == "valid"]
    if len(nodes) != len(batches) or any(n != want for n in nodes):
        raise AssertionError(f"{label}: valid graphs' kernel nodes {nodes}, want {want} each")
    return {"kinds": kinds, "note_midi_max_abs": worst, "nodes": nodes[0]}


def step_timing(torch, task, state, batch, reps=5):
    """Median synchronized wall of ``reps`` steps on one batch, then one
    profiled step's device time (CUDA activity) and busy share of that
    median."""
    batch = task.to_device(batch)
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        task.train_step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    prof = profile_pass(torch, lambda: (task.train_step(state, batch), torch.cuda.synchronize()))
    wall_ms = statistics.median(walls) * 1e3
    return {"wall_ms_median": wall_ms, "walls_ms": [w * 1e3 for w in walls],
            "dispatch": task.last_dispatch, "device_ms": prof["device_ms"],
            "busy_share": prof["device_ms"] / wall_ms, "by_group_ms": prof["by_group_ms"]}


def fit_graph_vs_eager(torch, workdir: pathlib.Path, steps: int = 6):
    """``Trainer.fit`` (what ``python -m some_tpu_torch.train`` runs) at
    production width for ``steps`` steps on items of one bucket (8 x 1024,
    40 notes), validating at the middle and the end on two one-row items of
    one bucket, under the default dispatch and under the eager one: the
    graph run's steps are eager, capture, then replays, its validation
    forwards eager, capture, replay, replay; each step's and validation
    forward's launches (a replay's as its graph's nodes) are one step's;
    the two runs end with equal weights and optimizer state, bit for bit."""
    from some_tpu_torch.training.base_task import set_train_dispatch
    from some_tpu_torch.training.trainer import Trainer

    rng = np.random.default_rng(29)
    items = [make_item(rng, int(rng.integers(924, 1025)), 40, 80) for _ in range(24)]
    valid = [make_item(rng, int(rng.integers(924, 1025)), 40, 80) for _ in range(2)]
    config = production_config(val_check_interval=steps // 2, num_sanity_val_steps=0,
                               log_interval=steps, max_val_batch_size=1)
    want = train_step_launches(config, ALL_TRAIN_KERNELS)
    want_valid = per_valid_forward(config)
    runs = {}
    for dispatch in ("graph", "eager"):
        task = in_memory_task(config, items, valid)
        if dispatch == "eager":
            set_train_dispatch(task, "eager")
        trainer = Trainer(task, workdir / f"fit-{dispatch}")
        trainer._save_ckpt = lambda *args: None  # no checkpoint files: the states are compared
        state = trainer.fit(max_steps=steps)
        records = task.step_records
        for i, rec in enumerate(records):
            check_step_launches(f"fit {dispatch} step {i}", rec["launches"], rec["dispatch"],
                                rec["graph_nodes"], {n: want.get(n, 0) for n in rec["launches"]})
        for launches_v, (kind, nodes) in zip(task.valid_launches, task.valid_dispatch):
            check_step_launches(f"fit {dispatch} validation", launches_v, kind, nodes,
                                {n: want_valid.get(n, 0) for n in launches_v})
        runs[dispatch] = ([r["dispatch"] for r in records], [d for d, _ in task.valid_dispatch],
                          state, [r["s"] for r in records])
    (kinds, valid_kinds, state_g, walls), (_, _, state_e, eager_walls) = runs["graph"], \
        runs["eager"]
    if kinds != ["eager", "capture"] + ["replay"] * (steps - 2) or valid_kinds != [
            "eager", "capture", "replay", "replay"]:
        raise AssertionError(f"fit: steps ran {kinds}, validation forwards {valid_kinds}")
    differ = states_differ(torch, state_g, state_e)
    if differ:
        raise AssertionError(f"fit: the graph run's state differs from the eager run's in "
                             f"{differ[:6]}")
    out = {"steps": kinds, "validation": valid_kinds, "step_s_graph": walls,
           "step_s_eager": eager_walls}
    log("train_graph fit, Trainer.fit of 6 steps at 8 x 1024 (a bucket), the default dispatch "
        "against the eager one: the state bit for bit; " + json.dumps(out))
    return out


def train_graph(torch, workdir: pathlib.Path, rows=8, frames=2048):
    """The compiled train and valid steps (``base_task``: one CUDA graph per
    batch bucket and accumulation position, captured at a bucket's second
    visit) against the test-only eager dispatch, from equal seeded states:

    * production width (configs/midi_conformer.yaml, bf16, remat, dropout
      0.1), default and opt-in, two buckets in turns (``rows`` x ``frames``
      and ``rows`` x ``frames`` / 2), 6 steps (eager, eager, capture,
      capture, replay, replay): losses and grad_norm at every step, then
      every parameter, BatchNorm statistic, AdamW moment and step count and
      the lr, bit for bit; each step graph's hand-written kernel nodes (K1
      34, dx 18, dw 18, K2 or K4 fwd+res 34, dk/dv 18, dq 18); the valid
      step on two buckets, graph vs eager, with its graphs' nodes (K1 18, K2
      18; opt-in K1 18, K3 36, K4 18); each bucket's capture seconds, the
      train pool's GiB; the step wall (median of 5, synchronized) of the
      replay and of the eager step, and each one's device time;
    * the same bit-for-bit check, on one (8, 512) bucket over 3 steps, under
      ``dots``, ``dots_no_batch`` and ``save_attn_conv``; with
      ``accumulate_grad_batches: 2`` and ``in_proj_midi`` frozen over two
      buckets in turns (6 micro-steps; the frozen weights unmoved); in a
      one-process NCCL group; and for the discrete task (configs/
      discrete.yaml, bf16), its valid step too;
    * ``Trainer.fit`` under both dispatches (``fit_graph_vs_eager``)."""
    import socket

    from some_tpu_torch.parallel import distributed as dist

    result = {}
    big = synthetic_items(21, rows, 80, lo=frames - 100, hi=frames)
    half = synthetic_items(22, rows, 80, lo=frames // 2 - 100, hi=frames // 2)
    valid = [synthetic_items(23, 1, 80, lo=900, hi=1000), synthetic_items(24, 1, 80, lo=1900,
                                                                          hi=2000)]
    for opt_in in (False, True):
        tag = "opt_in" if opt_in else "default"
        t_case = time.perf_counter()
        config = production_config(**(OPT_IN if opt_in else {}))
        graph, state_g, eager, state_e = graph_pair(torch, config)
        batches = [graph.collate(items) for items in (big, half) * 3]
        torch.cuda.synchronize()
        kinds, capture_s, nodes = graph_vs_eager_steps(torch, f"train_graph {tag}", graph,
                                                       state_g, eager, state_e, batches)
        if kinds != ["eager", "eager", "capture", "capture", "replay", "replay"]:
            raise AssertionError(f"train_graph {tag}: steps ran {kinds}")
        entry = {"kinds": kinds, "capture_s": capture_s, "step_graph_nodes": nodes[0],
                 "train_pool_gib": pool_gib(torch, state_g.pools["train"])}
        entry["valid"] = graph_vs_eager_valid(torch, f"train_graph {tag}", graph, state_g,
                                              eager, state_e,
                                              [graph.collate(items) for items in valid])
        entry["valid_pool_gib"] = pool_gib(torch, state_g.pools["valid"])
        entry["graph_step"] = step_timing(torch, graph, state_g, batches[0])
        entry["eager_step"] = step_timing(torch, eager, state_e, batches[0])
        if entry["graph_step"]["dispatch"] != "replay":
            raise AssertionError(f"train_graph {tag}: the timed steps were not replays")
        entry["s"] = time.perf_counter() - t_case
        log(f"train_graph {tag}, {rows} x {frames} and {rows} x {frames // 2} bf16: 6 steps and "
            f"the state bit for bit with eager; " + json.dumps(entry))
        result[tag] = entry
        del graph, state_g, eager, state_e, batches
        torch.cuda.empty_cache()

    a = synthetic_items(25, rows, 80, lo=412, hi=512)
    b = synthetic_items(26, rows, 80, lo=284, hi=384)
    cases = [(f"remat_{p}", production_config(remat_policy=p), [a] * 3)
             for p in ("dots", "dots_no_batch", "save_attn_conv")]
    cases.append(("accumulate_frozen", production_config(
        accumulate_grad_batches=2, freezing_enabled=True,
        frozen_params=["model.backbone.in_proj_midi"]), [a, b] * 3))
    cases.append(("nccl_world_one", production_config(), [a] * 3))
    discrete = production_config("discrete.yaml", pl_trainer_precision="bf16")
    cases.append(("discrete", discrete, [synthetic_items(27, rows, 80, lo=412, hi=512,
                                                         discrete=True)] * 3))
    for name, config, item_batches in cases:
        t_case = time.perf_counter()
        grouped = name == "nccl_world_one"
        if grouped:
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            os.environ.update(SOME_TPU_COORDINATOR=f"127.0.0.1:{port}",
                              SOME_TPU_NUM_PROCESSES="1", SOME_TPU_PROCESS_ID="0")
        try:
            if grouped and not (dist.maybe_initialize("cuda")
                                and torch.distributed.get_backend() == "nccl"):
                raise AssertionError("train_graph: no NCCL group of one")
            graph, state_g, eager, state_e = graph_pair(torch, config)
            frozen = (state_g.model.backbone.in_proj_midi.weight.detach().clone()
                      if name == "accumulate_frozen" else None)
            kinds, capture_s, nodes = graph_vs_eager_steps(
                torch, f"train_graph {name}", graph, state_g, eager, state_e,
                [graph.collate(items) for items in item_batches])
            entry = {"kinds": kinds, "capture_s": capture_s, "step_graphs": len(nodes),
                     "step_graph_nodes": nodes[0]}
            if frozen is not None and not torch.equal(
                    state_g.model.backbone.in_proj_midi.weight, frozen):
                raise AssertionError("train_graph accumulate_frozen: the frozen weights moved")
            if name == "discrete":
                entry["valid"] = graph_vs_eager_valid(
                    torch, f"train_graph {name}", graph, state_g, eager, state_e,
                    [graph.collate(items) for items in (synthetic_items(
                        28, 1, 80, lo=900, hi=1000, discrete=True),)])
            replays = kinds.count("replay")
            if not replays or (name == "accumulate_frozen" and len(nodes) != 2):
                raise AssertionError(f"train_graph {name}: steps {kinds}, {len(nodes)} graphs")
            del graph, state_g, eager, state_e
        finally:
            if grouped:
                for key in ("SOME_TPU_COORDINATOR", "SOME_TPU_NUM_PROCESSES",
                            "SOME_TPU_PROCESS_ID"):
                    os.environ.pop(key, None)
                dist.destroy()
        torch.cuda.empty_cache()
        entry["s"] = time.perf_counter() - t_case
        log(f"train_graph {name}: bit for bit with eager; " + json.dumps(entry))
        result[name] = entry
    result["fit"] = fit_graph_vs_eager(torch, workdir)
    return result


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


def dft_spectrum_ms(torch, wave: np.ndarray, config: dict) -> dict:
    """The dft spectrum's ms on the card on [rows, samples] audio: its two
    products (frames @ dft_cos, frames @ dft_sin) in f32, as before the
    repair, and in f64, as ``LogMelSpec`` takes them there now, beside
    cuFFT's rfft of the same frames."""
    from some_tpu_torch.ops.melspec import LogMelSpec

    mel = LogMelSpec(n_mels=config["units_dim"], sample_rate=config["audio_sample_rate"],
                     win_length=config["win_size"], hop_length=config["hop_size"],
                     fmin=config["fmin"], fmax=config["fmax"], method="dft", device="cuda")
    win, hop = config["win_size"], config["hop_size"]
    audio = torch.nn.functional.pad(torch.from_numpy(wave).cuda(), (win // 2, (win + 1) // 2))
    frames = audio.unfold(-1, win, hop).contiguous()
    f64 = frames.double()
    cos32, sin32 = mel.dft_cos.float(), mel.dft_sin.float()

    def f32_products():
        re, im = frames @ cos32, frames @ sin32
        return torch.sqrt(re * re + im * im)

    def f64_products():
        re, im = f64 @ mel.dft_cos, f64 @ mel.dft_sin
        return torch.sqrt(re * re + im * im).float()

    def cufft():
        spec = torch.fft.rfft(frames * mel.window, dim=-1)
        return spec[..., mel._k_lo:mel._k_hi].abs()

    return {name: median_ms(torch, fn) for name, fn in
            (("f32", f32_products), ("f64", f64_products), ("cufft", cufft))}


def mel_check(torch, setup: dict, workdir: pathlib.Path):
    """``mel_method: dft`` in one default bf16 engine on the four songs
    (graph dispatch after prewarm), its log-mel against the rfft one on the
    card, on every group's real frames: at most 1e-2 apart wherever the mel
    is at least 1e-3 (100 x the clamp), the JAX docstring's figure; and at
    every bin no farther from an f64 log-mel than the port's CPU dft (f32
    products, which lose the quiet bins to cancellation: JAX's own dft and
    rfft are 0.027 apart there on these songs). Then the spectrum's times
    (``dft_spectrum_ms``), note F1 against the rfft engine's (the default bf16 main
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
    cpu_dft = LogMelSpec(n_mels=config["units_dim"], sample_rate=config["audio_sample_rate"],
                         win_length=config["win_size"], hop_length=config["hop_size"],
                         fmin=config["fmin"], fmax=config["fmax"], method="dft", device="cpu")
    groups, _ = engine.bucket_groups(setup["chunks"])
    err = {"dft_vs_rfft_above_1e-3": 0.0, "dft_vs_rfft": 0.0, "dft_vs_f64": 0.0,
           "rfft_vs_f64": 0.0, "cpu_dft_vs_f64": 0.0}
    largest = None
    for _, audio, mask in groups:
        wave = decode_wire_device(torch.from_numpy(audio).cuda(), engine.wire,
                                  n_samples=mask.shape[1] * engine.hop - 1)
        got, want = engine.mel(wave).cpu().numpy(), rfft(wave).cpu().numpy()
        on_cpu = cpu_dft(wave.cpu()).numpy()
        ref = f64_log_mel(wave.cpu().numpy(), config)
        loud = mask[..., None] & (ref >= np.log(1e-3))
        real = np.broadcast_to(mask[..., None], ref.shape)
        for key, value in (("dft_vs_rfft_above_1e-3", np.abs(got - want)[loud]),
                           ("dft_vs_rfft", np.abs(got - want)[real]),
                           ("dft_vs_f64", np.abs(got - ref)[real]),
                           ("rfft_vs_f64", np.abs(want - ref)[real]),
                           ("cpu_dft_vs_f64", np.abs(on_cpu - ref)[real])):
            err[key] = max(err[key], float(value.max()))
        if largest is None or wave.numel() > largest.numel():
            largest = wave
    spectrum_ms = dft_spectrum_ms(torch, largest.cpu().numpy(), config)
    mel_ms = {name: {"ms": median_ms(torch, lambda: mel(largest)),
                     "device_ms": device_ms(torch, lambda: mel(largest), calls=10)}
              for name, mel in (("dft", engine.mel), ("rfft", rfft))}
    audio_s = setup["audio_s"]
    log(f"dft mel, default bf16: log-mel max |d| on the songs' real frames {err} (dft vs "
        f"rfft limit 1e-2 where the mel >= 1e-3); note F1 against the rfft engine {f1}; warm "
        f"RTF {audio_s / statistics.median(walls):.2f}x; mel device ms on "
        f"{list(largest.shape)} samples: {mel_ms}; pass device ms "
        f"{prof['device_ms']:.1f}, by group {prof['by_group_ms']}")
    log(f"dft mel at every bin against the f64 log-mel: the card {err['dft_vs_f64']:.3e}, "
        f"the port's CPU dft {err['cpu_dft_vs_f64']:.3e}; the spectrum's ms on the card "
        f"{json.dumps(spectrum_ms)} (f32: the products before, f64: now)")
    if not err["dft_vs_rfft_above_1e-3"] <= 1e-2:
        raise AssertionError(f"dft log-mel differs from rfft: {err}")
    if not err["dft_vs_f64"] <= err["cpu_dft_vs_f64"]:
        raise AssertionError(f"dft log-mel on the card is farther from f64 than the CPU's: {err}")
    del engine
    torch.cuda.empty_cache()
    return {"max_abs_logmel": err, "f1_vs_rfft": f1,
            "rtf_warm_median": audio_s / statistics.median(walls), "mel_device_ms": mel_ms,
            "mel_samples_shape": list(largest.shape), "profile": prof,
            "dft_spectrum_ms": spectrum_ms}


class AttributeDict(dict):
    """Stands for Lightning's hyper-parameter dict: pickled as a class that
    ``torch.load(weights_only=True)`` refuses, as a Lightning file's are."""


def lightning_check(torch, workdir: pathlib.Path, setup: dict):
    """A reference Lightning checkpoint at production width: ``OracleModel``
    (tests/torch_oracle.py, the reference's key layout, torch only;
    ``SHALLOW_LAYERS`` layers, dim 512, 8 x 64 heads, k 31, 80 -> 128) with random BatchNorm
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
    config["midi_extractor_args"] = dict(config["midi_extractor_args"], lay=SHALLOW_LAYERS)
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


EXPORT_BUCKET = 512


def export_song() -> np.ndarray:
    """A melody of 5.5 s (474 frames: bucket 512), the length the export
    phase runs through the loaded programs."""
    return make_song(2024, phrases=1, notes_per_phrase=16)[:int(5.5 * SR)]


def export_program(torch, label: str, config: dict, state: dict, out: pathlib.Path,
                   per_forward: dict, song: np.ndarray) -> tuple:
    """Export bucket ``EXPORT_BUCKET`` of ``config`` on the card, load it, and
    run ``song`` through it twice from launch counts at 0 (each forward must
    launch ``per_forward``), then through the exporter's engine under eager
    dispatch on the same bucket: probs and bounds bit for bit are expected,
    else their largest difference is printed; the notes are held to the
    graph-vs-eager rule either way (counts, durations and rests equal,
    note_midi within 1e-3). Returns (result, launches of the two forwards)."""
    from some_tpu_torch.deployment.export import MIDIExtractionExporter, load_exported
    from some_tpu_torch.inference.base_infer import set_dispatch

    t0 = time.perf_counter()
    exporter = MIDIExtractionExporter(config, state_dict=state, device="cuda")
    t1 = time.perf_counter()
    exporter.export(out, buckets=(EXPORT_BUCKET,))
    t2 = time.perf_counter()
    pipeline = load_exported(out)
    t3 = time.perf_counter()
    engine = exporter.engine
    set_dispatch(engine, "eager")
    groups, _ = engine.bucket_groups([song])
    (_, audio, mask), = groups
    if tuple(mask.shape) != (1, EXPORT_BUCKET):
        raise AssertionError(f"{label}: the song's bucket is {tuple(mask.shape)}")
    reset_counts()
    runs = [pipeline.run_bucket(audio, mask) for _ in range(2)]
    torch.cuda.synchronize()
    launched = read_counts()
    want_launches = {name: 2 * per_forward.get(name, 0) for name in launched}
    if launched != want_launches:
        raise AssertionError(f"{label}: two forwards of the loaded program launched "
                             f"{launched}, want {want_launches}")
    got = runs[0]
    if not all(torch.equal(runs[1][k], got[k]) for k in got):
        raise AssertionError(f"{label}: two forwards of the loaded program differ")
    want = engine.run_bucket_staged(*engine.stage_inputs(audio, mask), frames=True)
    diffs = {key: float((got[key].float() - want[key].float()).abs().max())
             for key in ("probs", "bounds")}
    bit_for_bit = all(torch.equal(got[key], want[key]) for key in ("probs", "bounds"))
    for key in ("n_notes", "note_dur", "note_rest"):
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"{label}: program vs eager dispatch {key} differ "
                                 f"(probs, bounds max |d| {diffs})")
    midi_diff = float((got["note_midi"] - want["note_midi"]).abs().max())
    if midi_diff > 1e-3:
        raise AssertionError(f"{label}: program vs eager note_midi differ by {midi_diff}")
    notes = pipeline(song)
    if len(notes["note_dur"]) != int(want["n_notes"][0]) or not len(notes["note_dur"]) \
            or not np.isfinite(notes["note_midi"]).all():
        raise AssertionError(f"{label}: the loaded pipeline sliced {len(notes['note_dur'])} "
                             f"notes, want {int(want['n_notes'][0])}")
    program_ms = median_ms(torch, lambda: pipeline.run_bucket(audio, mask), reps=5, warmup=1)
    eager_ms = median_ms(torch, lambda: engine.run_bucket(audio, mask), reps=5, warmup=1)
    size = (out / f"bucket_{EXPORT_BUCKET}.pt2").stat().st_size
    result = {"engine_s": t1 - t0, "export_s": t2 - t1, "load_s": t3 - t2, "pt2_bytes": size,
              "per_forward": {n: c // 2 for n, c in launched.items() if c},
              "probs_bounds_bit_for_bit": bit_for_bit, "max_abs_diff": diffs,
              "max_note_midi_diff": midi_diff, "notes": len(notes["note_dur"]),
              "program_forward_ms": program_ms, "eager_forward_ms": eager_ms}
    log(f"export {label}: engine {t1 - t0:.1f} s, torch.export + save {t2 - t1:.1f} s, load "
        f"{t3 - t2:.1f} s, bucket_{EXPORT_BUCKET}.pt2 {size} bytes; a forward launches "
        f"{result['per_forward']}; probs and bounds against eager dispatch "
        f"{'bit for bit' if bit_for_bit else f'max |d| {diffs}'}, note_midi max |d| "
        f"{midi_diff}, {result['notes']} notes; a forward {program_ms:.2f} ms (eager "
        f"dispatch {eager_ms:.2f} ms)")
    del pipeline, exporter, engine
    torch.cuda.empty_cache()
    return result, launched


def cut_depth(config: dict, state: dict, lay: int) -> tuple:
    """(config, state dict) of the model's first ``lay`` dual-stream layers
    (the in-projections, the final blocks and the heads kept): the same
    width at a smaller depth."""
    layer = re.compile(r"(^|\.)layer_(\d+)\.")
    state = {k: v for k, v in state.items()
             if not (layer.search(k) and int(layer.search(k).group(2)) >= lay)}
    config = dict(config, midi_extractor_args=dict(config["midi_extractor_args"], lay=lay))
    return config, state


def shallow_model(workdir: pathlib.Path, setup: dict) -> pathlib.Path:
    """``workdir/default-bf16-shallow/model.pt``: the infer set-up's
    checkpoint cut to its first ``SHALLOW_LAYERS`` dual-stream layers, with
    its bf16 config beside it; written once."""
    from some_tpu_torch.config import save_yaml
    from some_tpu_torch.utils.checkpoint import load_state_dict, save_checkpoint

    d = workdir / "default-bf16-shallow"
    if not d.is_dir():
        config, state = cut_depth(dict(setup["config"], pl_trainer_precision="bf16"),
                                  load_state_dict(setup["ckpt"]), SHALLOW_LAYERS)
        d.mkdir()
        save_yaml(config, d / "config.yaml")
        save_checkpoint(d / "model.pt", state)
    return d / "model.pt"


def export_check(torch, workdir: pathlib.Path):
    """The export path from the default bf16 checkpoint of the infer phase
    (``default-bf16/model.pt``), at production width and ``SHALLOW_LAYERS``
    of its dual-stream layers (``cut_depth``: what exports is the same at
    any depth, and tracing and saving 8 layers took most of a minute):

    * pt2: ``export_program`` of the default configuration (K1 and K2 once
      a block: 6 each at 2 layers) and of the opt-in one (``fuse_ffn``,
      ``attention_impl: splash``: K1 6, K3 12, K4 6), each traced on the
      card at bucket 512;
    * onnx: ``export_onnx`` (traced on the CPU) of the same weights; its
      summary read by ``deployment/onnx_inspect.py`` (opset 17, the I/O
      names and dynamic axes, every load-bearing op, three ``Conv`` and five
      ``LayerNormalization`` a block); ``deployment/onnx_run.py`` on the first
      3 s of the song against the ONNX module run eagerly on the CPU
      (tests/test_onnx_export.py's tolerances: note_midi 1e-4, rests equal,
      durations 1e-6).

    Prints torch's version and whether the private function that the
    onnx-less export patches exists, and each artifact's size."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    from some_tpu_torch.config import load_yaml
    from some_tpu_torch.deployment.onnx_export import _PATCH_KNOWN_TORCH
    from some_tpu_torch.utils.checkpoint import load_state_dict

    has_hook = callable(getattr(onnx_proto_utils, "_add_onnxscript_fn", None))
    log(f"export: torch {torch.__version__}; onnx_proto_utils._add_onnxscript_fn "
        f"{'exists' if has_hook else 'is missing'}; the onnx-less patch is verified on torch "
        f"{_PATCH_KNOWN_TORCH}")
    model = workdir / "default-bf16" / "model.pt"
    config, state = cut_depth(load_yaml(model.with_name("config.yaml")),
                              load_state_dict(model), SHALLOW_LAYERS)
    args = config["midi_extractor_args"]
    blocks = 2 * args["lay"] + 2
    song = export_song()
    result, launches = {"torch": torch.__version__, "add_onnxscript_fn": has_hook}, {}
    for tag, overrides, per_forward in (
            ("default", {}, {"depthwise_conv1d": blocks, "flash_attention": blocks}),
            ("opt_in", OPT_IN, {"depthwise_conv1d": blocks, "fused_ln_ffn_residual": 2 * blocks,
                                "splash_attention": blocks})):
        result[tag], launches[f"export_{tag}"] = export_program(
            torch, tag, dict(config, **overrides), state, workdir / f"export-{tag}",
            per_forward, song)
    result["onnx"] = onnx_check(torch, config, state, song, workdir)
    return result, launches


def onnx_check(torch, config: dict, state: dict, song: np.ndarray, workdir: pathlib.Path):
    """The ONNX half of ``export_check``."""
    from some_tpu_torch.deployment.onnx_export import build_onnx_module, export_onnx
    from some_tpu_torch.deployment.onnx_inspect import read_model_summary
    from some_tpu_torch.deployment.onnx_run import run_graph

    blocks = 2 * config["midi_extractor_args"]["lay"] + 2
    t0 = time.perf_counter()
    onnx_path = export_onnx(config, state, workdir / "model.onnx")
    export_s = time.perf_counter() - t0
    summary = read_model_summary(onnx_path)
    ops = summary["op_types"]
    problems = []
    if summary["opset"] != 17:
        problems.append(f"opset {summary['opset']}")
    if [n for n, _ in summary["inputs"]] != ["waveform"] or summary["inputs"][0][1][1] != \
            "n_samples":
        problems.append(f"inputs {summary['inputs']}")
    if [n for n, _ in summary["outputs"]] != ["note_midi", "note_rest", "note_dur"] or any(
            dims[1] != "n_notes" for _, dims in summary["outputs"]):
        problems.append(f"outputs {summary['outputs']}")
    for op in ("STFT", "Conv", "MatMul", "LayerNormalization", "Sigmoid", "CumSum",
               "ScatterElements", "ArgMax"):
        if not ops[op]:
            problems.append(f"no {op}")
    if ops["Conv"] != 3 * blocks or ops["LayerNormalization"] != 5 * blocks:
        problems.append(f"{ops['Conv']} Conv and {ops['LayerNormalization']} "
                        f"LayerNormalization for {blocks} blocks")
    if problems:
        raise AssertionError(f"ONNX graph: {problems}")
    short = song[:3 * SR]
    t0 = time.perf_counter()
    got = run_graph(onnx_path, {"waveform": short[None]})
    run_s = time.perf_counter() - t0
    module = build_onnx_module(config, state)
    with torch.no_grad():
        want = [t.numpy() for t in module(torch.from_numpy(short[None]))]
    if got[0].shape != want[0].shape or not got[0].shape[1]:
        raise AssertionError(f"ONNX graph: {got[0].shape} notes, the module {want[0].shape}")
    errs = {"note_midi": float(np.abs(got[0] - want[0]).max()),
            "note_dur": float(np.abs(got[2] - want[2]).max()),
            "note_rest_equal": bool(np.array_equal(got[1].astype(bool), want[1].astype(bool)))}
    if errs["note_midi"] > 1e-4 or errs["note_dur"] > 1e-6 or not errs["note_rest_equal"]:
        raise AssertionError(f"ONNX graph vs the eager module: {errs}")
    result = {"export_s": export_s, "bytes": onnx_path.stat().st_size,
              "op_types": sum(ops.values()), "run_s": run_s, "notes": got[0].shape[1],
              "vs_eager": errs}
    log(f"export onnx: traced on the CPU in {export_s:.1f} s, {onnx_path.stat().st_size} "
        f"bytes, opset 17, {sum(ops.values())} nodes ({ops['Conv']} Conv, {ops['MatMul']} "
        f"MatMul, {ops['LayerNormalization']} LayerNormalization); the numpy executor ran "
        f"{len(short) / SR:.1f} s of audio in {run_s:.1f} s to {got[0].shape[1]} notes, "
        f"against the eager module {errs}")
    return result


def oversize_split(torch, workdir: pathlib.Path, setup: dict):
    """Song 0 through one default bf16 engine (``shallow_model``: production
    width, ``SHALLOW_LAYERS`` layers) whose frame buckets stop at
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

    model = shallow_model(workdir, setup)
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
    blocks = 2 * SHALLOW_LAYERS + 2
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


# ---- the serving surfaces and the native host plane ----

# ``python -m some_tpu_torch.stream`` as runpy runs it, in a process that
# writes its kernel launches to argv[1] when the stream ends
STREAM_CHILD = """
import json, runpy, sys
out = sys.argv.pop(1)
try:
    runpy.run_module("some_tpu_torch.stream", run_name="__main__", alter_sys=True)
finally:
    from chip_smoke import read_counts
    with open(out, "w") as f:
        json.dump(read_counts(), f)
"""


def median_s(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def host_split(torch, engine, setup: dict, workdir: pathlib.Path, reps: int = 5) -> dict:
    """The host's work in a warm file pass, per song, on this machine's CPU:
    WAV decode, slicing with the Python scan (``rms_envelope`` +
    ``scan_silence``) and with the native one (``SilenceSlicer.slice``),
    the wire encoding of the chunks (``bucket_groups``: padding, encode)
    and the MIDI write; beside them the half-rate wire's FIR (its numpy
    plain version and native, held bit for bit) and the warm file pass itself
    (``transcribe_file``, the graphs captured). Medians of ``reps``; the
    FIR on song 0 only, its plain version once."""
    from some_tpu_torch import native
    from some_tpu_torch.audio.slicer import SilenceSlicer, rms_envelope, scan_silence
    from some_tpu_torch.audio.wavio import _decimate_fir, load_wav, wire_decimation_taps
    from some_tpu_torch.infer import transcribe_file
    from some_tpu_torch.inference.pipeline import MAX_SIL_KEPT_MS
    from some_tpu_torch.utils.midi_file import build_midi_file

    slicer = SilenceSlicer(sr=SR, max_sil_kept=MAX_SIL_KEPT_MS)
    taps = wire_decimation_taps(2)

    def python_slice(wave):
        rms = rms_envelope(wave, slicer.win_size, slicer.hop_size)
        tags = scan_silence(rms, slicer.threshold, slicer.min_interval, slicer.min_length,
                            slicer.max_sil_kept)
        return slicer.apply_tags(wave, tags, rms.shape[0])

    songs = []
    for i, wav in enumerate(setup["wavs"]):
        wave = load_wav(wav, sr=SR)[0]
        chunks, py_chunks = slicer.slice(wave), python_slice(wave)
        if [(c["offset"], len(c["waveform"])) for c in chunks] != \
                [(c["offset"], len(c["waveform"])) for c in py_chunks]:
            raise AssertionError(f"song {i}: the native slicer's chunks differ from the Python "
                                 "scan's")
        waves = [c["waveform"] for c in chunks]
        segments = engine.infer(waves)
        offsets = [c["offset"] for c in chunks]
        midi = workdir / f"host-{i}.mid"
        ms = {name: 1e3 * median_s(fn, reps) for name, fn in (
            ("decode", lambda: load_wav(wav, sr=SR)),
            ("slice_python", lambda: python_slice(wave)),
            ("slice_native", lambda: slicer.slice(wave)),
            ("encode", lambda: engine.bucket_groups(waves)),
            ("midi_write", lambda: build_midi_file(offsets, segments).save(midi)))}
        if i == 0:  # the half-rate wire's FIR, once: its plain version takes seconds
            t0 = time.perf_counter()
            plain = _decimate_fir(wave, taps, 2)
            ms["fir_plain"] = 1e3 * (time.perf_counter() - t0)
            ms["fir_native"] = 1e3 * median_s(lambda: native.decimate_fir_native(wave, taps, 2),
                                              reps)
            if not np.array_equal(native.decimate_fir_native(wave, taps, 2), plain):
                raise AssertionError("song 0: the native FIR differs from its plain version")
        transcribe_file(engine, wav, midi)
        torch.cuda.synchronize()
        ms["file_pass"] = 1e3 * median_s(
            lambda: (transcribe_file(engine, wav, midi), torch.cuda.synchronize()), 3)
        rest = ms["decode"] + ms["encode"] + ms["midi_write"]
        ms["host_python"] = rest + ms["slice_python"]
        ms["host_native"] = rest + ms["slice_native"]
        songs.append({"audio_s": len(wave) / SR, "chunks": len(chunks), "ms": ms,
                      "host_share_native": ms["host_native"] / ms["file_pass"]})
    log("host split per song (ms, medians of 5; the warm file pass of 3): " + json.dumps(
        [{k: round(v, 3) for k, v in song["ms"].items()} for song in songs]))
    return {"songs": songs, "reps": reps}


def surface_launches(label: str, counts: dict, per_forward: dict) -> dict:
    """Raise unless the path launched each kernel of ``per_forward`` and no
    other."""
    if any(counts[n] == 0 for n in per_forward) or any(
            c for n, c in counts.items() if n not in per_forward):
        raise AssertionError(f"{label}: launches {counts}, want {sorted(per_forward)} only")
    return counts


def serve_check(torch, engine, setup: dict, workdir: pathlib.Path) -> dict:
    """``make_server`` on 127.0.0.1:0 over ``engine``; each song POSTed
    twice, 8 requests at once; every reply's notes against
    ``transcribe_waveform`` on the same engine (F1 >= 0.95; how many came
    back byte for byte the same), /healthz ok, /stats 8 completions."""
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from some_tpu_torch.audio.wavio import load_wav
    from some_tpu_torch.inference.pipeline import transcribe_waveform
    from some_tpu_torch.serve import make_server
    from some_tpu_torch.utils.midi_file import MidiFile, midi_notes_to_arrays
    from some_tpu_torch.utils.note_f1 import note_f1

    direct = []
    for i, wav in enumerate(setup["wavs"]):
        direct.append(workdir / f"serve-direct-{i}.mid")
        transcribe_waveform(engine, load_wav(wav, sr=SR)[0], SR).save(direct[-1])
    httpd, dispatcher = make_server(engine, engine.config, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    bodies = [wav.read_bytes() for wav in setup["wavs"]] * 2

    def post(body):
        req = urllib.request.Request(base + "/transcribe?tempo=120", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()

    forwards = engine.forwards
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
            replies = list(pool.map(post, bodies))
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        with urllib.request.urlopen(base + "/stats", timeout=30) as resp:
            stats = json.loads(resp.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
    f1s, same = [], 0
    for i, (status, midi) in enumerate(replies):
        if status != 200 or midi[:4] != b"MThd":
            raise AssertionError(f"serve: request {i} answered {status}")
        got = workdir / f"serve-reply-{i}.mid"
        got.write_bytes(midi)
        want = direct[i % len(direct)]
        same += midi == want.read_bytes()
        f1s.append(note_f1(midi_notes_to_arrays(MidiFile.load(want)),
                           midi_notes_to_arrays(MidiFile.load(got)),
                           onset_tolerance=0.05, pitch_tolerance=0.5).f1)
    log(f"serve: {len(replies)} concurrent requests in {wall:.3f} s, {stats['batches']} "
        f"batches (at most {stats['max_jobs_per_batch']} jobs), {engine.forwards - forwards} "
        f"graph replays; note F1 against the direct engine {[round(f, 4) for f in f1s]}, "
        f"{same} of {len(replies)} byte for byte; /healthz {health['status']}; /stats "
        f"requests {stats['requests']}, RTF {stats['infer_rtf']:.2f}x of engine.infer time")
    if min(f1s) < 0.95 or health["status"] != "ok" or stats["requests"] != len(replies):
        raise AssertionError(f"serve: F1 {f1s}, health {health}, stats {stats}")
    return {"requests": len(replies), "wall_s": wall, "f1_vs_direct": f1s,
            "byte_identical": same, "health": health, "stats": stats,
            "replays": engine.forwards - forwards}


def batch_infer_check(setup: dict, workdir: pathlib.Path, model: pathlib.Path) -> dict:
    """``some_tpu_torch.batch_infer`` over a DiffSinger-style set made from
    the songs (``wavs/*.wav``, a ``transcriptions.csv`` of seeded words of
    1-3 phonemes spanning each song): every row gains note_seq/note_dur, as
    many of each, and its note_dur sums to the words' span."""
    import csv

    from some_tpu_torch import batch_infer
    from some_tpu_torch.audio.wavio import load_wav

    data = workdir / "diffsinger"
    (data / "wavs").mkdir(parents=True)
    rng = np.random.default_rng(27182)
    rows = []
    for i, wav in enumerate(setup["wavs"]):
        os.symlink(wav, data / "wavs" / f"song{i}.wav")
        total = len(load_wav(wav, sr=SR)[0]) / SR
        cuts = [0.0]
        while total - cuts[-1] > 1.5:
            cuts.append(cuts[-1] + float(rng.uniform(0.3, 1.2)))
        cuts.append(total)
        ph_dur, ph_num = [], []
        for a, b in zip(cuts[:-1], cuts[1:]):
            n = int(rng.integers(1, 4))
            inner = np.sort(rng.uniform(a, b, n - 1))
            ph_dur += [round(float(d), 6) for d in np.diff(np.concatenate([[a], inner, [b]]))]
            ph_num.append(n)
        rows.append({"name": f"song{i}", "ph_seq": " ".join("a" * len(ph_dur)),
                     "ph_dur": " ".join(str(d) for d in ph_dur),
                     "ph_num": " ".join(str(n) for n in ph_num)})
    with open(data / "transcriptions.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["name", "ph_seq", "ph_dur", "ph_num"])
        writer.writeheader()
        writer.writerows(rows)
    out = workdir / "labelled.csv"
    t0 = time.perf_counter()
    batch_infer.main(["--dataset", str(data), "--model", str(model), "--csv", str(out)])
    wall = time.perf_counter() - t0
    with open(out, newline="") as f:
        labelled = list(csv.DictReader(f))
    spans = []
    for row, want in zip(labelled, rows):
        seq, durs = row["note_seq"].split(), [float(d) for d in row["note_dur"].split()]
        span = sum(float(d) for d in want["ph_dur"].split())
        if not seq or len(seq) != len(durs) or abs(sum(durs) - span) > 1e-4:
            raise AssertionError(f"batch_infer: row {row['name']}: {len(seq)} notes, "
                                 f"{len(durs)} durations summing to {sum(durs)}, span {span}")
        spans.append({"notes": len(seq), "span_s": span, "note_dur_sum_s": sum(durs)})
    if len(labelled) != len(rows):
        raise AssertionError(f"batch_infer: {len(labelled)} rows written of {len(rows)}")
    log(f"batch_infer: {len(rows)} rows labelled in {wall:.2f} s (engine load included): "
        + json.dumps(spans))
    return {"rows": spans, "wall_s": wall}


def stream_check(torch, setup: dict, workdir: pathlib.Path, model: pathlib.Path) -> dict:
    """Song 0 as s16le PCM into ``python -m some_tpu_torch.stream`` (runpy,
    STREAM_CHILD) in 100 ms chunks, with --prewarm-buckets set to the song's
    buckets: fed at real-time pace from its ready marker until the first
    event arrives (the first-event latency: that event's arrival less the
    audio time of its phrase's end), then as fast as the pipe takes it. Its
    --midi against the offline path on the same weights and samples,
    ``transcribe_waveform`` with one chunk a forward as the stream
    dispatches (required byte for byte), and with the engine's default
    batching (recorded)."""
    import queue
    import threading

    from some_tpu_torch.audio.wavio import load_wav
    from some_tpu_torch.infer import load_engine
    from some_tpu_torch.inference.base_infer import pick_bucket
    from some_tpu_torch.inference.pipeline import slice_waveform, transcribe_waveform

    wave = load_wav(setup["wavs"][0], sr=SR)[0]
    pcm = np.clip(np.round(wave * 32768.0), -32768, 32767).astype("<i2")
    samples = pcm.astype(np.float32) / 32768.0  # what the stream decodes
    chunks = slice_waveform(samples, SR)
    hop = setup["config"]["hop_size"]
    buckets = sorted({pick_bucket(len(c["waveform"]) // hop + 1) for c in chunks})
    midi, counts_path = workdir / "stream.mid", workdir / "stream-launches.json"
    proc = subprocess.Popen(
        [sys.executable, "-c", STREAM_CHILD, str(counts_path), "--model", str(model),
         "--midi", str(midi), "--chunk-ms", "100",
         "--prewarm-buckets", ",".join(str(b) for b in buckets)],
        cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    events, errs, ready = queue.Queue(), [], threading.Event()

    def read_stdout():
        for line in proc.stdout:
            events.put((time.perf_counter(), json.loads(line)))

    def read_stderr():
        for line in proc.stderr:
            errs.append(line.decode(errors="replace"))
            if b"| ready" in line:
                ready.set()

    readers = [threading.Thread(target=read_stdout, daemon=True),
               threading.Thread(target=read_stderr, daemon=True)]
    for reader in readers:
        reader.start()
    try:
        t_spawn = time.perf_counter()
        if not ready.wait(timeout=240):
            raise AssertionError("stream: no ready marker:\n" + "".join(errs)[-4000:])
        ready_s = time.perf_counter() - t_spawn
        step = SR // 10  # 100 ms of samples
        t_start = time.perf_counter()
        paced = True
        for pos in range(0, len(pcm), step):
            proc.stdin.write(pcm[pos:pos + step].tobytes())
            proc.stdin.flush()
            if paced:
                if not events.empty():
                    paced = False  # the first event is in: feed the rest at once
                else:
                    lag = (pos + step) / SR - (time.perf_counter() - t_start)
                    if lag > 0:
                        time.sleep(lag)
        fed_s = time.perf_counter() - t_start
        proc.stdin.close()
        if proc.wait(timeout=240) != 0:
            raise AssertionError(f"stream exited {proc.returncode}:\n" + "".join(errs)[-4000:])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for reader in readers:
        reader.join(timeout=30)
    got = []
    while not events.empty():
        got.append(events.get())
    if len(got) != len(chunks):
        raise AssertionError(f"stream: {len(got)} events for {len(chunks)} offline chunks")
    t_first, first = got[0]
    phrase_end = first["offset_sec"] + sum(first["note_dur_sec"])
    latency = t_first - t_start - phrase_end
    launches = json.loads(counts_path.read_text())

    offline = {}
    for name, rows in (("one_chunk_a_forward", 1), ("batched", 8)):
        engine = load_engine(model, device="cuda", quiet=True, max_batch_chunks=rows)
        offline[name] = transcribe_waveform(engine, samples, SR).serialize() == midi.read_bytes()
        del engine
    torch.cuda.empty_cache()
    log(f"stream: song 0 ({len(samples) / SR:.2f} s, buckets {buckets}) ready {ready_s:.2f} s "
        f"after spawn; {len(got)} events; first-event latency {latency:.3f} s (phrase end "
        f"{phrase_end:.3f} s of audio); fed in {fed_s:.2f} s; --midi equal to the offline path "
        f"byte for byte: " + json.dumps(offline))
    if not offline["one_chunk_a_forward"]:
        raise AssertionError("stream: its MIDI differs from the offline path's")
    return {"audio_s": len(samples) / SR, "buckets": buckets, "events": len(got),
            "ready_s": ready_s, "first_event_latency_s": latency,
            "first_phrase_end_s": phrase_end, "fed_s": fed_s, "midi_equal_offline": offline,
            "launches": launches}


def surfaces(torch, workdir: pathlib.Path, setup: dict):
    """The serving surfaces on the default bf16 configuration at production
    width, each from launch counts at 0: the server (``load_engine`` and
    ``prewarm`` of the songs' buckets, as ``serve --prewarm`` does, then
    ``serve_check``; ``host_split`` runs on its engine before it serves),
    ``batch_infer_check`` and ``stream_check``. Requires the native host
    plane built and called (no silent fallback). Returns (results,
    {surface: launches})."""
    from some_tpu_torch import native
    from some_tpu_torch.infer import load_engine

    if not native.native_available():
        raise AssertionError(f"the native host plane did not build: "
                             f"{native.unavailable_reason()}")
    native.reset_calls()
    model = workdir / "default-bf16" / "model.pt"
    blocks = setup["blocks"]
    per_forward = {"depthwise_conv1d": blocks, "flash_attention": blocks}
    launches = {}

    reset_counts()
    engine = load_engine(model, device="cuda", quiet=True)
    n_graphs = engine.prewarm(setup["buckets"])
    result = {"host_split": host_split(torch, engine, setup, workdir),
              "serve": serve_check(torch, engine, setup, workdir)}
    if engine.graphs_captured != n_graphs:
        raise AssertionError(f"serve: {engine.graphs_captured - n_graphs} graphs captured "
                             "after the prewarm")
    result["serve"]["graph_launches"] = {n: c * result["serve"]["replays"]
                                         for n, c in per_forward.items()}
    launches["serve"] = surface_launches("serve", read_counts(), per_forward)
    del engine
    torch.cuda.empty_cache()

    reset_counts()
    result["batch_infer"] = batch_infer_check(setup, workdir, model)
    launches["batch_infer"] = surface_launches("batch_infer", read_counts(), per_forward)
    torch.cuda.empty_cache()

    result["stream"] = stream_check(torch, setup, workdir, model)
    launches["stream"] = surface_launches("stream", result["stream"].pop("launches"),
                                          per_forward)
    calls = native.read_calls()
    if not (calls["rms_envelope_native"] and calls["slicer_scan_native"]
            and calls["decimate_fir_native"]):
        raise AssertionError(f"the native host plane was not called: {calls}")
    result["native_calls"] = calls
    log(f"surfaces: launches {json.dumps(launches)}; native calls {json.dumps(calls)}")
    return result, launches


def kernels_on_second_card(torch) -> dict:
    """K1-K4 and the backward kernels on ``cuda:1`` while device 0 is
    current, in f32 (each wrapper makes the tensor's device current for its
    launch): bit for bit the same kernels' results on ``cuda:0``, and within
    their plain versions' tolerances on ``cuda:1`` (K1's forward and dx bit
    for bit; the backward kernels 2 ulp + 0.002 RMS, K1 dw 1e-4 RMS);
    device 0 still current after. Returns max |d|/tol by kernel."""
    from some_tpu_torch.ops import attention as A
    from some_tpu_torch.ops import depthwise as W
    from some_tpu_torch.ops import fused_ffn as K3

    gen = torch.Generator().manual_seed(11)

    def draw(*shape):
        return torch.randn(*shape, generator=gen)

    B, H, T, D, C = 2, 8, 300, 64, 512
    host = {"x": draw(B, T, C), "w": draw(31, C) / 8, "g": draw(B, T, C),
            "q": draw(B, H, T, D), "k": draw(B, H, T, D), "v": draw(B, H, T, D),
            "do": draw(B, H, T, D), "ffn": draw(B, T, C),
            "ln": [torch.ones(C), torch.zeros(C), draw(C, 4 * C) / C, torch.zeros(4 * C),
                   draw(4 * C, C) / (4 * C), torch.zeros(C)]}
    host_mask = torch.ones(B, T, dtype=torch.bool)
    host_mask[1, 200:] = False

    def run(device):
        t = {k: ([x.to(device) for x in v] if isinstance(v, list) else v.to(device))
             for k, v in host.items()}
        t["mask"] = host_mask.to(device)
        q, k, v, do, m = t["q"], t["k"], t["v"], t["do"], t["mask"]
        out = {"k1": W.depthwise_conv1d(t["x"], t["w"]),
               "k1_dx": W.depthwise_conv1d_dx(t["g"], t["w"]),
               "k1_dw": W.depthwise_conv1d_dw(t["x"], t["g"], 31)}
        with torch.no_grad():
            out["k2"] = A.flash_attention(q, k, v, m, 0.125)
            out["k3"] = K3.fused_ln_ffn_residual(t["ffn"], *t["ln"])
            out["k4"] = A.splash_attention(q, k, v, m, 0.125)
        o, t["stats"] = A.flash_attention_fwd_res(q, k, v, m, 0.125)
        t["delta"] = (do * o).sum(-1).contiguous()
        out["k2_dq"], out["k2_delta"] = A.flash_attention_bwd_dq(q, k, v, do, t["stats"],
                                                                 t["delta"], m, 0.125)
        out["k2_dk"], out["k2_dv"] = A.flash_attention_bwd_dkv(q, k, v, do, t["stats"],
                                                               out["k2_delta"], m, 0.125)
        o4, t["lse"], _ = A.splash_attention_fwd_res(q, k, v, m)
        t["di"] = A.splash_di(o4, None, do)
        out["k4_dk"], out["k4_dv"] = A.splash_attention_bwd_dkv(q, k, v, do, t["lse"], t["di"], m)
        out["k4_dq"] = A.splash_attention_bwd_dq(q, k, v, do, t["lse"], t["di"], m)
        torch.cuda.synchronize(device)
        return t, out

    torch.cuda.set_device(0)
    want_bits = run(torch.device("cuda", 0))[1]
    t, got = run(torch.device("cuda", 1))
    if torch.cuda.current_device() != 0:
        raise AssertionError(f"device {torch.cuda.current_device()} current after the launches")
    for key, value in got.items():
        if value.device != torch.device("cuda", 1) or not torch.equal(value.cpu(),
                                                                      want_bits[key].cpu()):
            raise AssertionError(f"{key} on cuda:1 differs from cuda:0's ({value.device})")
    q, k, v, do, m = t["q"], t["k"], t["v"], t["do"], t["mask"]
    wants = {"k1": (W.depthwise_conv1d_plain(t["x"], t["w"]), None),
             "k1_dx": (W.depthwise_conv1d_plain(t["g"], t["w"].flip(0)), None),
             "k1_dw": (W.depthwise_conv1d_dw_plain(t["x"], t["g"], 31), 1e-4),
             "k2": (A.attention_plain(q, k, v, m, 0.125), attention_tolerance),
             "k3": (K3.fused_ln_ffn_residual_plain(t["ffn"], *t["ln"]), fused_ffn_tolerance),
             "k4": (A.splash_attention_plain(q, k, v, m, 0.125), splash_forward_tolerance),
             "k2_dq": (A.flash_attention_bwd_dq_plain(q, k, v, do, t["stats"], t["delta"], m,
                                                      0.125)[0], 0.002),
             "k4_dq": (A.splash_attention_bwd_dq_plain(q, k, v, do, t["lse"], t["di"], m),
                       0.002)}
    dk, dv = A.flash_attention_bwd_dkv_plain(q, k, v, do, t["stats"], got["k2_delta"], m, 0.125)
    wants.update(k2_dk=(dk, 0.002), k2_dv=(dv, 0.002))
    dk, dv = A.splash_attention_bwd_dkv_plain(q, k, v, do, t["lse"], t["di"], m)
    wants.update(k4_dk=(dk, 0.002), k4_dv=(dv, 0.002))
    ratios = {}
    for key, (want, tol) in wants.items():
        if tol is None:
            ratios[key] = 0.0 if torch.equal(got[key], want) else float("inf")
            continue
        tol = grad_tolerance(torch, want, tol) if isinstance(tol, float) else tol(torch, want)
        ratios[key] = float(((got[key].float() - want.float()).abs() / tol).max())
    log("kernels on cuda:1 with device 0 current, max |d|/tol against the plain versions: "
        + json.dumps(ratios))
    if not all(r <= 1.0 for r in ratios.values()):
        raise AssertionError(f"a kernel on cuda:1 disagrees with its plain version: {ratios}")
    # a fault of any launch above is charged here, not to the next caller
    for d in (1, 0):
        torch.cuda.synchronize(d)
    return ratios


def mesh_pass(torch, engine, wavs, workdir: pathlib.Path, tag: str):
    """One file pass of the songs through ``transcribe_file``: (MIDI paths, s)."""
    from some_tpu_torch.infer import transcribe_file

    t0 = time.perf_counter()
    paths = [transcribe_file(engine, wav, workdir / f"{tag}-{i}.mid")
             for i, wav in enumerate(wavs)]
    for r in engine.replicas:
        torch.cuda.synchronize(r.device)
    return paths, time.perf_counter() - t0


def mesh_run(torch, workdir: pathlib.Path, setup: dict, one, devices, per_forward,
             quantize: bool = False) -> tuple:
    """One serving mesh in default bf16 over ``devices``, from launch counts
    at 0: built (through ``load_engine(devices=2)`` on two cards, through
    the engine's ``mesh`` where both replicas share ``cuda:0``), ``prewarm``
    of the songs' buckets (each replica captures the shard buckets; launches
    = 2 x per forward x graphs x replicas) and a file pass of the four songs,
    which captures nothing more. Then: notes against the one engine ``one``
    (F1 >= 0.95 in bf16: a shard changes cuBLAS's M); warm passes of the one
    engine and the mesh in turns (RTF, not gated: two replicas on one card
    share its SMs); the peak reserved GiB the mesh added on each device (its
    weights, graph pools, staging and warm-ups) and that over its replicas
    there; an
    eager bucket run launching each replica's forward; each replica's graph
    of every bucket holding one forward's hand-written kernels (its kernel
    nodes). ``quantize``: the int8 phase's checkpoint (``quantize: int8``),
    ``one`` an int8 engine, and per forward ``INT8_SITES`` exchanges a
    replica besides K1 and K2: in the eager bucket run every replica's max
    at every site is recorded and must be the same bit for bit, each
    replica's graph is printed under ``alone()`` (a group of one), and one
    replica's ``_run`` alone must be refused. Returns (result, launches)."""
    from some_tpu_torch.config import load_yaml
    from some_tpu_torch.infer import load_engine
    from some_tpu_torch.inference.base_infer import build_inference, set_dispatch
    from some_tpu_torch.parallel.mesh import make_mesh, pad_rows, split_rows
    from some_tpu_torch.utils.midi_file import MidiFile, midi_notes_to_arrays
    from some_tpu_torch.utils.note_f1 import note_f1

    tag = "default-int8-bf16" if quantize else "default-bf16"
    model, wavs, audio_s = workdir / tag / "model.pt", setup["wavs"], setup["audio_s"]
    cards = sorted(set(devices))
    label = "+".join(devices) + (" int8" if quantize else "")
    torch.cuda.empty_cache()
    base = {}
    for card in cards:
        torch.cuda.reset_peak_memory_stats(torch.device(card))
        base[card] = torch.cuda.memory_reserved(torch.device(card))
    reset_counts()
    t0 = time.perf_counter()
    if len(cards) == len(devices):
        mesh = load_engine(model, quiet=True, devices=len(devices))
    else:
        mesh = build_inference(load_yaml(model.with_name("config.yaml")), model,
                               mesh=make_mesh(devices))
    build_s = time.perf_counter() - t0
    if [str(r.device) for r in mesh.replicas] != list(devices):
        raise AssertionError(f"mesh {label}: replicas on {[str(r.device) for r in mesh.replicas]}")
    if (mesh.model.quant == "int8") != quantize or (mesh._member is not None) != quantize:
        raise AssertionError(f"mesh {label}: model {mesh.model.quant}, group {mesh._member}")
    t0 = time.perf_counter()
    n = mesh.prewarm(setup["buckets"])
    prewarm_s = time.perf_counter() - t0
    midis, first_s = mesh_pass(torch, mesh, wavs, workdir, f"mesh-{label}-first")
    launched = read_counts()
    graphs = [r.graphs_captured for r in mesh.replicas]
    want = {name: 2 * c * n * len(devices) for name, c in per_forward.items()}
    if graphs != [n] * len(devices) or launched != {name: want.get(name, 0) for name in launched}:
        raise AssertionError(f"mesh {label}: graphs {graphs} (prewarm {n}), launches {launched}, "
                             f"want {want}")
    one_midis, _ = mesh_pass(torch, one, wavs, workdir, f"mesh-{label}-one")
    f1 = [note_f1(midi_notes_to_arrays(MidiFile.load(a)), midi_notes_to_arrays(MidiFile.load(b)),
                  onset_tolerance=0.05, pitch_tolerance=0.5).f1 for a, b in zip(one_midis, midis)]
    if min(f1) < 0.95:
        raise AssertionError(f"mesh {label}: note F1 against one engine {f1} below 0.95")
    warm = {"one": [], "mesh": []}
    for name in ("one", "mesh", "mesh", "one", "one", "mesh"):
        warm[name].append(mesh_pass(torch, one if name == "one" else mesh, wavs, workdir,
                                    f"mesh-{label}-{name}-warm")[1])
    rtf = {name: audio_s / statistics.median(times) for name, times in warm.items()}
    peak = {card: (torch.cuda.max_memory_reserved(torch.device(card)) - base[card]) / 2 ** 30
            for card in cards}
    per_replica = {card: peak[card] / devices.count(card) for card in cards}

    groups, _ = mesh.bucket_groups(setup["chunks"])
    set_dispatch(mesh, "eager")
    if quantize:
        # the bucket's first eager run warms each replica's stream up against
        # a group of one (base_infer._warm_up): the counted run is the second
        mesh.run_bucket(*groups[0][1:])
    sites = [[] for _ in mesh.replicas]
    for replica, seen in zip(mesh.replicas, sites):
        if replica._member is not None:
            def recording(amax, exchange=replica._member.max, seen=seen):
                seen.append(exchange(amax))
                return seen[-1]

            replica._member.max = recording
    reset_counts()
    mesh.run_bucket(*groups[0][1:])
    for card in cards:
        torch.cuda.synchronize(torch.device(card))
    eager = {name: c for name, c in read_counts().items() if c}
    if eager != {name: c * len(devices) for name, c in per_forward.items()}:
        raise AssertionError(f"mesh {label}: an eager bucket run launched {eager}")
    same_scale = None
    if quantize:
        for replica in mesh.replicas:
            del replica._member.max
        got = [torch.stack(seen).cpu() for seen in sites]
        if len(got[0]) != INT8_SITES or not all(torch.equal(g, got[0]) for g in got[1:]):
            raise AssertionError(f"mesh {label}: the replicas' maxes at the int8 sites differ "
                                 f"({[len(g) for g in got]} sites)")
        from some_tpu_torch.inference.base_infer import SITES_PER_GRAPH

        segments = sorted({len(e.graphs) for r in mesh.replicas for e in r._graphs.values()})
        if segments != [INT8_SITES // SITES_PER_GRAPH + 1]:
            raise AssertionError(f"mesh {label}: graph segments a bucket {segments}")
        same_scale = {"sites": len(got[0]), "replicas": len(got), "graph_segments": segments[0],
                      "min_sx": float(torch.clamp(got[0] / 127.0, min=1e-8).min())}
        a, m, _ = mesh.replicas[1]._stage(*(x[:1] for x in groups[0][1:]))
        try:
            mesh.replicas[1]._run(a, m, None, False, False)
        except RuntimeError as exc:
            same_scale["lone_run_refused"] = str(exc)
        else:
            raise AssertionError(f"mesh {label}: a replica's _run alone was not refused")
    set_dispatch(mesh, "graph")
    nodes = []
    for _, audio, mask in {g[2].shape[1]: g for g in groups}.values():  # one group a bucket
        shards = zip(*(split_rows(x, len(devices))
                       for x in pad_rows(audio, mask, len(devices), mesh.wire,
                                         mask.shape[1] * mesh.hop - 1)))
        for replica, (a, m) in zip(mesh.replicas, shards):
            with replica.alone():
                held = hand_written(graph_kernel_nodes(torch, replica, a, m))
            if held != per_forward:
                raise AssertionError(f"mesh {label}: {replica.device}'s graph of shard "
                                     f"{m.shape} holds {held}, want {per_forward}")
            nodes.append({"device": str(replica.device), "shard": list(m.shape), **held})
    result = {"devices": list(devices), "build_s": build_s, "prewarm_graphs_per_replica": n,
              "graphs_per_replica": graphs, "prewarm_s": prewarm_s, "first_s": first_s,
              "forwards_per_replica": [r.forwards for r in mesh.replicas],
              "f1_vs_one_engine": f1, "warm_s": warm, "rtf_warm_median": rtf,
              "peak_reserved_gib": peak, "peak_reserved_gib_per_replica": per_replica,
              "eager_bucket_launches": eager, "graph_kernel_nodes": nodes,
              "weight_bytes": mesh.weight_bytes, "int8_sites": same_scale}
    log(f"mesh {label}: built in {build_s:.2f} s, prewarm {n} shard graphs a replica in "
        f"{prewarm_s:.2f} s; launches {launched} (captures only); F1 vs one engine {f1}; warm "
        f"RTF mesh {rtf['mesh']:.2f}x vs one engine {rtf['one']:.2f}x on the same card(s); "
        f"peak reserved GiB added {peak} ({per_replica} a replica); an eager bucket {eager}; "
        f"graph kernel nodes {nodes}; int8 sites {same_scale}")
    del mesh
    torch.cuda.empty_cache()
    return result, launched


def mesh_f32_bucket(torch, workdir: pathlib.Path, setup: dict, devices) -> dict:
    """One bucket in 32-true, the songs' group with the most rows, through a
    mesh over ``devices`` and one engine: every real row's note counts,
    durations and rests equal, note_midi within 1e-3 (the decode's atomic
    index_add_)."""
    from some_tpu_torch.config import load_yaml
    from some_tpu_torch.infer import load_engine
    from some_tpu_torch.inference.base_infer import build_inference
    from some_tpu_torch.parallel.mesh import make_mesh

    model = workdir / "default-32-true" / "model.pt"
    one = load_engine(model, device="cuda", quiet=True)
    mesh = build_inference(load_yaml(model.with_name("config.yaml")), model,
                           mesh=make_mesh(devices))
    groups, _ = one.bucket_groups(setup["chunks"])
    jobs, audio, mask = max(groups, key=lambda g: len(g[0]))
    got = {k: v[:len(jobs)].cpu() for k, v in mesh.run_bucket(audio, mask).items()}
    want = {k: v[:len(jobs)].cpu() for k, v in one.run_bucket(audio, mask).items()}
    for key in ("n_notes", "note_dur", "note_rest"):
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"mesh f32 bucket {tuple(mask.shape)}: {key} differs from one "
                                 "engine's")
    midi = float((got["note_midi"] - want["note_midi"]).abs().max())
    if midi > 1e-3:
        raise AssertionError(f"mesh f32 bucket {tuple(mask.shape)}: note_midi {midi} apart")
    log(f"mesh f32 bucket {tuple(mask.shape)} over {devices}: {len(jobs)} rows, notes equal "
        f"(note_midi {midi:.2e} apart)")
    del one, mesh
    torch.cuda.empty_cache()
    return {"bucket": list(mask.shape), "rows": len(jobs), "max_note_midi_diff": midi}


def mesh_check(torch, workdir: pathlib.Path, setup: dict):
    """The serving mesh (the CLIs' ``--devices N``) in default bf16 at
    production width, on the infer phase's checkpoint and songs: two
    replicas on ``cuda:0`` (a mesh may repeat a device), and ``cuda:0`` +
    ``cuda:1`` where two cards exist (``mesh_run`` each), one bucket in
    32-true (``mesh_f32_bucket``), and, on two cards, every kernel on
    ``cuda:1`` with device 0 current (``kernels_on_second_card``) and the
    exchange kernel across the two cards (``check_replica_max``). Then the
    same meshes with ``quantize: int8`` on the int8 phase's checkpoint,
    against that phase's bf16 engine of the default configuration, kept
    prewarmed (``mesh_run(quantize=True)``), and a lone replica's exchange
    in a child process, which must trap in its bound
    (``lone_replica_traps``). Returns (results, {path: launches})."""
    from some_tpu_torch.infer import load_engine

    blocks = setup["blocks"]
    per_forward = {"depthwise_conv1d": blocks, "flash_attention": blocks}
    meshes = [("cuda:0", "cuda:0")]
    if torch.cuda.device_count() >= 2:
        meshes.append(("cuda:0", "cuda:1"))
    else:
        log("mesh: one card present; the mesh over cuda:0 + cuda:1 and the kernels on cuda:1 "
            "are not run")
    one = load_engine(workdir / "default-bf16" / "model.pt", device="cuda", quiet=True)
    one.prewarm(setup["buckets"])
    results, launches = {"cards": torch.cuda.device_count()}, {}
    for devices in meshes:
        key = "one_card" if devices[0] == devices[1] else "two_cards"
        results[key], launches[f"mesh_{key}"] = mesh_run(torch, workdir, setup, one, devices,
                                                         per_forward)
    del one
    torch.cuda.empty_cache()
    results["f32_bucket"] = mesh_f32_bucket(torch, workdir, setup, meshes[-1])
    if len(meshes) > 1:
        results["kernels_on_cuda1"] = kernels_on_second_card(torch)
        # the exchange across the host link, after every kernel has run on both cards
        results["replica_max_two_cards"] = check_replica_max(torch, devices=meshes[-1])
    # the int8 phase's bf16 engine of the default configuration, prewarmed there
    one = setup.pop("int8_engine")
    per_forward = dict(per_forward, replica_max=INT8_SITES)
    for devices in meshes:
        key = "int8_one_card" if devices[0] == devices[1] else "int8_two_cards"
        results[key], launches[f"mesh_{key}"] = mesh_run(torch, workdir, setup, one, devices,
                                                         per_forward, quantize=True)
    del one
    torch.cuda.empty_cache()
    results["lone_replica"] = lone_replica_traps()
    log(f"mesh: a lone replica's exchange {json.dumps(results['lone_replica'])}")
    return results, launches


def sung_songs(seconds, seed: int) -> list:
    """Songs of the given lengths at 44.1 kHz, cut from make_song's melodies."""
    return [make_song(seed + i, phrases=int(s // 6) + 1)[:int(s * SR)]
            for i, s in enumerate(seconds)]


def voicing_report(got: np.ndarray, want: np.ndarray, peak: np.ndarray) -> dict:
    """Card vs CPU f0 curves (10 ms, Hz; 0 unvoiced): voicing agreement, the
    frames whose probability maximum lies within 1e-4 of the 0.03 threshold,
    the flips outside them, and the largest f0 difference in cents where
    both are voiced."""
    flip = (got > 0) != (want > 0)
    near = np.abs(peak - 0.03) <= 1e-4
    both = (got > 0) & (want > 0)
    cents = 1200 * np.abs(np.log2(got[both] / want[both])) if both.any() else np.zeros(1)
    return {"frames": int(got.size), "voiced_both": int(both.sum()),
            "agreement": float(1 - flip.mean()), "near_threshold": int(near.sum()),
            "flips_off_threshold": int((flip & ~near).sum()),
            "max_cents_voiced_both": float(cents.max())}


def binarize_check(torch, workdir: pathlib.Path, shortest: float = 5.0, longest: float = 60.0):
    """The preprocessing path on the card (``some_tpu_torch.binarize``'s):

    1. RMVPE at the published geometry (5 levels from 16 channels, 4 blocks,
       4 intermediate layers, BiGRU 256), seeded random weights with random
       BatchNorm statistics, saved as an upstream ``model.pt`` and loaded:
       one packed 8-row chunk of songs of 5-60 s on the card (its time and
       peak memory); two songs of about 10 s against the CPU, probabilities
       to 5e-5 + 1e-4 |want|, f0 in cents where both are voiced, voicing
       agreement (flips only within 1e-4 of the 0.03 threshold);
    2. the binarizer on a DiffSinger dataset of 16 songs of 5-60 s
       (``bench_binarize``'s, ``pe: rmvpe`` on that file, mel units,
       ``key_shift_factor: 2``): the card's pass is ``process()``, which
       writes ``train.data`` / ``valid.data`` with the port's HDF5 codec
       (``data/hdf5.py``: the card's machine has no h5py), the CPU's runs
       ``prepare_items`` and ``process_item`` over both splits without the
       write; every item's labels and units equal, its pitch within 1e-3
       semitone; the bench_binarize line of the card's pass; every item read
       back from the files equal to the card's in memory, bit for bit (the
       write's and the read's seconds, the files' bytes); then two train
       steps of the default model (configs/midi_conformer.yaml) on the 8
       shortest items of the written train set, read through the task's
       ``load_datasets``, with K1 and K2 launches counted from 0;
    3. ContentVec at full HuBERT-base width (768, 12 heads, FFN 3072, output
       layer 9) on seeded random weights: two songs of about 5 s on the card
       against the CPU (5e-5 + 1e-4 |want|), and the bucketed, masked
       forward against the unpadded one."""
    from some_tpu_torch import bench_binarize
    from some_tpu_torch.audio.wavio import resample
    from some_tpu_torch.nn import rmvpe as R
    from some_tpu_torch.nn.contentvec import ContentVecEncoder

    d = workdir / "binarize"
    d.mkdir()
    result, t_phase = {}, time.perf_counter()
    ckpt = bench_binarize.save_random_rmvpe(d / "model.pt", seed=2718)
    card, cpu = R.RMVPE(ckpt, device="cuda"), R.RMVPE(ckpt, device="cpu")

    # 1. RMVPE: one packed chunk at full width, then card vs CPU
    songs = sung_songs(np.linspace(shortest, longest, 8), seed=500)
    mels = [card.audio_to_mel(w, SR) for w in songs]
    (chunk, batch, t_valid), = list(card._packed_chunks(mels))
    torch.cuda.reset_peak_memory_stats()
    run = lambda: card._forward(batch, t_valid)  # noqa: E731
    chunk_ms = median_ms(torch, run, reps=3, warmup=1)
    hidden = run().cpu().numpy()
    if not np.isfinite(hidden).all() or hidden.std() < 1e-3:
        raise AssertionError(f"RMVPE chunk output: finite {np.isfinite(hidden).all()}, "
                             f"std {hidden.std()}")
    result["rmvpe_chunk"] = {"rows_frames": list(batch.shape[:2]), "t_valid": t_valid.tolist(),
                             "ms": chunk_ms,
                             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del hidden
    two = sung_songs([10.3, 9.7], seed=600)
    two_mels = [cpu.audio_to_mel(w, SR) for w in two]
    worst = 0.0
    for got, want in zip(card.mel2hidden_batch(two_mels), cpu.mel2hidden_batch(two_mels)):
        worst = max(worst, float((np.abs(got - want) / (5e-5 + 1e-4 * np.abs(want))).max()))
    voicing = []
    for m, got, want in zip(two_mels, card.f0_batch(two, SR), cpu.f0_batch(two, SR)):
        voicing.append(voicing_report(got, want, cpu.mel2hidden(m)[0].max(axis=1)))
    result["rmvpe_vs_cpu"] = {"max_prob_diff_over_tol": worst, "voicing": voicing}
    log(f"binarize: RMVPE chunk {result['rmvpe_chunk']}; card vs CPU on two ~10 s songs: "
        f"{json.dumps(result['rmvpe_vs_cpu'])}")
    if worst > 1 or any(v["flips_off_threshold"] or v["max_cents_voiced_both"] > 0.01
                        for v in voicing):
        raise AssertionError(f"RMVPE on the card differs from the CPU: {result['rmvpe_vs_cpu']}")
    result["rmvpe_s"] = time.perf_counter() - t_phase

    # 2. the binarizer: the card's pass (written) against the CPU's, the
    # written set read back, then two train steps read from it
    from some_tpu_torch.data.indexed_dataset import IndexedDataset
    from some_tpu_torch.preprocessing.me_binarizer import MIDI_EXTRACTION_ITEM_ATTRIBUTES

    t0 = time.perf_counter()
    seconds = [float(s) for s in np.round(np.linspace(shortest, longest, 16), 1)]
    audio_s = bench_binarize.write_song_dataset(d / "raw", np.random.default_rng(42), seconds)
    passes = {}
    for device in ("cuda", "cpu"):
        config = bench_binarize.bench_config(d / "raw", d / f"binary-{device}", ckpt, aug=2,
                                             units_dim=80)
        passes[device] = bench_binarize.timed_pass(config, device, write=device == "cuda")
    line = bench_binarize.bench_line(passes["cuda"][0], len(seconds), audio_s, "cuda",
                                     aug_factor=2)
    log("bench_binarize (the card's pass, written): " + json.dumps(line))
    pitch_diff, n_items = 0.0, 0
    items = {}
    for prefix in ("valid", "train"):
        got = items[prefix] = [i for group in passes["cuda"][1][prefix] for i in group]
        want = [i for group in passes["cpu"][1][prefix] for i in group]
        if len(got) != len(want) or not got:
            raise AssertionError(f"{prefix}: {len(got)} items on the card, {len(want)} on the CPU")
        for a, b in zip(got, want):
            if a.keys() != b.keys():
                raise AssertionError(f"{prefix}: keys {sorted(a)} vs {sorted(b)}")
            for key in a:
                if key == "pitch":
                    pitch_diff = max(pitch_diff, float(np.abs(a[key] - b[key]).max()))
                elif not np.array_equal(a[key], b[key]):
                    raise AssertionError(f"{prefix} item {n_items}: {key} differs card vs CPU")
            n_items += 1
    if pitch_diff > 1e-3:
        raise AssertionError(f"binarized pitch differs card vs CPU by {pitch_diff} semitones")
    del passes
    # the written set, read back with the port's codec: every item the card's
    # in-memory item, bit for bit (the fields the binarizer writes)
    binary = d / "binary-cuda"
    t_read = time.perf_counter()
    read = {prefix: [ds[i] for i in range(len(ds))]
            for prefix, ds in ((p, IndexedDataset(binary, p)) for p in ("valid", "train"))}
    read_s = time.perf_counter() - t_read
    for prefix, want in items.items():
        if len(read[prefix]) != len(want):
            raise AssertionError(f"{prefix}: {len(read[prefix])} items read, {len(want)} written")
        for i, (got, item) in enumerate(zip(read[prefix], want)):
            item = {k: v for k, v in item.items() if k in MIDI_EXTRACTION_ITEM_ATTRIBUTES}
            if sorted(got) != sorted(item) or not all(
                    np.asarray(got[k]).dtype == np.asarray(v).dtype
                    and np.asarray(got[k]).tobytes() == np.asarray(v).tobytes()
                    for k, v in item.items()):
                raise AssertionError(f"{prefix} item {i} read back differs from the card's")
    files = {prefix: (binary / f"{prefix}.data").stat().st_size for prefix in read}
    result["binarizer"] = {"items": n_items, "max_pitch_diff_semitones": pitch_diff,
                           "bench_binarize": line,
                           "hdf5_write_s": line["hdf5_write_s"], "hdf5_read_s": read_s,
                           "hdf5_bytes": files}
    log(f"binarize: the card's set written in {line['hdf5_write_s']:.3f} s ({files} bytes) and "
        f"read back in {read_s:.3f} s, {n_items} items = the card's in memory")
    del items, read
    # two train steps of the default model on the 8 shortest items of the
    # written train set, read through the task's own load_datasets
    task = recording_task(production_config(binary_data_dir=str(binary)))
    (train_set, train_lengths), _ = task.load_datasets()
    shortest_items = [train_set[int(i)] for i in np.argsort(train_lengths, kind="stable")[:8]]
    state = task.init_state(seed=2718)
    batch = task.to_device(task.collate(shortest_items))
    reset_counts()
    for _ in range(2):
        logs = task.train_step(state, batch)
    launched = read_counts()
    losses = [r["total_loss"] for r in task.step_records]
    if not (np.isfinite(losses).all() and launched["depthwise_conv1d"]
            and launched["flash_attention_fwd_res"]):
        raise AssertionError(f"train steps on the written set: losses {losses}, "
                             f"launches {launched}")
    result["train_steps"] = {"batch": [int(batch["size"]), int(batch["units"].shape[1])],
                             "total_loss": losses, "grad_norm": float(logs["grad_norm"]),
                             "launches": {n: c for n, c in launched.items() if c}}
    log(f"binarize: {n_items} items card = CPU (pitch within {pitch_diff:.3g} semitone); two "
        f"train steps read from the written set: {json.dumps(result['train_steps'])}")
    del task, state, batch, train_set
    torch.cuda.empty_cache()
    result["binarizer_s"] = time.perf_counter() - t0

    # 3. ContentVec at full width
    t0 = time.perf_counter()
    encoder = ContentVecEncoder(None, device="cuda", seed=31)
    cpu_encoder = ContentVecEncoder(None, device="cpu", seed=31)
    worst, masked = 0.0, 0.0
    for wave in sung_songs([5.2, 4.7], seed=700):
        got, want = encoder(wave, SR), cpu_encoder(wave, SR)
        worst = max(worst, float((np.abs(got - want) / (5e-5 + 1e-4 * np.abs(want))).max()))
        w16 = torch.from_numpy(resample(wave, SR, 16000)[None]).cuda()
        with torch.no_grad():
            unpadded = encoder.model(w16)[0].cpu().numpy()
        masked = max(masked, float((np.abs(got - unpadded) / (5e-5 + 1e-4 * np.abs(unpadded)))
                                   .max()))
    result["contentvec"] = {"layers": len(encoder.model.layers), "frames": int(got.shape[0]),
                            "card_vs_cpu_over_tol": worst, "padded_vs_unpadded_over_tol": masked,
                            "s": time.perf_counter() - t0}
    log(f"binarize: ContentVec full width {json.dumps(result['contentvec'])}")
    if worst > 1 or masked > 1:
        raise AssertionError(f"ContentVec on the card: {result['contentvec']}")
    del encoder, cpu_encoder
    torch.cuda.empty_cache()
    return result, launched


def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True)
    return float(smi.stdout.strip().splitlines()[0])


def mesh_only(torch) -> int:
    """``python chip_smoke.py --mesh``: the ``mesh`` phase alone, on the
    infer phase's set-up (checkpoint, songs) and the int8 phase's prewarmed
    engine, for checking the two-card branch on a machine with two cards
    without the rest. Prints the phase's results; it is not the smoke test
    (it prints no ``ok`` line)."""
    from some_tpu_torch.infer import load_engine
    from some_tpu_torch.ops import _build

    _build.build()
    log(f"{torch.cuda.device_count()} cards: {torch.cuda.get_device_name(0)}")
    with tempfile.TemporaryDirectory(prefix="some_tpu_torch_mesh_") as tmp:
        work = pathlib.Path(tmp)
        setup = infer_setup(work)
        for precision in ("bf16", "32-true"):
            model_dir(work, setup, "default", precision, False, False)
        engine = load_engine(model_dir(work, setup, "default-int8", "bf16", False, True),
                             device="cuda", quiet=True)
        engine.prewarm(setup["buckets"])
        setup["int8_engine"] = engine
        t0 = time.perf_counter()
        results, launches = mesh_check(torch, work, setup)
        results["phase_s"] = time.perf_counter() - t0
        log(f"phase mesh: {results['phase_s']:.1f} s")
    print(json.dumps({"mesh": results, "launches": launches}), flush=True)
    return 0


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
    if sys.argv[1:] == ["--mesh"]:
        return mesh_only(torch)
    cache_inits()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
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
    rows["replica_max"] = [phase("check_replica_max", check_replica_max, torch)]
    report_tensor_core_kernels(rows, hmma)
    routes = phase("routes", check_routes, torch)

    launches, results = {}, {"routes": routes}
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
        results["train_rest"], launches["train_rest"] = phase("train_rest", train_rest, torch,
                                                              work)
        reset_counts()
        results["train_graph"] = phase("train_graph", train_graph, torch, work)
        launches["train_graph"] = read_counts()
        never = [n for n in ALL_TRAIN_KERNELS + ("depthwise_conv1d", "flash_attention",
                                                 "fused_ln_ffn_residual", "splash_attention")
                 if not launches["train_graph"][n]]
        if never:
            raise AssertionError(f"train_graph never launched {never}: {launches['train_graph']}")
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
        results["surfaces"], surface_counts = phase("surfaces", surfaces, torch, work, setup)
        launches.update(surface_counts)
        results["mesh"], mesh_counts = phase("mesh", mesh_check, torch, work, setup)
        launches.update(mesh_counts)
        results["binarize"], launches["binarize_train"] = phase("binarize", binarize_check,
                                                                torch, work)
        results["export"], export_counts = phase("export", export_check, torch, work)
        launches.update(export_counts)
        # after every profiled replay: with these 66 graphs captured earlier
        # in the process, torch.profiler has missed a kernel record of a replay
        model = work / "default-bf16" / "model.pt"
        results["full_prewarm"] = phase("full_prewarm", full_prewarm, torch, model)
        results["cold_cli"] = phase("cold_cli", cold_cli, torch, model, setup["wavs"][0], work,
                                    reps=1)
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
        ("splash_attention_bwd_dq", "splash_attention_bwd.cu", f"{splash_py}:1307"),
        # no TPU kernel: the counterpart of GSPMD's all-reduce of this max
        ("replica_max", "replica_max.cu", "some_tpu/ops/quant.py:40"))

    def entry(name, source, replaces):
        head = rows[name][0]  # [8, ...] bf16: the production dtype at a main-path batch
        by_path = {path: counts.get(name, 0) for path, counts in launches.items()}
        tensor_core = [kernel for _, kernel, wrapper in TENSOR_CORE_KERNELS if wrapper == name]
        return {"name": name, "route": "cuda", "source": f"some_tpu_torch/csrc/{source}",
                "bf16_hmma": ({n: c for n, c in hmma.items() if tensor_core[0] in n}
                              if tensor_core else None),
                "bf16_registers": ({n: r for n, r in registers.items() if tensor_core[0] in n}
                                   if tensor_core else None),
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "launches_per_train_step": {
                    **{tag: results[f"train_{tag}"]["launches_per_step"].get(name, 0)
                       for tag in ("default", "opt_in", "discrete")},
                    **{f"remat_{tag}": policy["launches"].get(name, 0)
                       for tag, policy in results["train_rest"]["remat"].items()}},
                "graph_nodes_per_train_step": {
                    tag: case["step_graph_nodes"].get(name, 0)
                    for tag, case in results["train_graph"].items()
                    if "step_graph_nodes" in case},
                "graph_nodes_per_valid_step": {
                    tag: case["valid"]["nodes"].get(name, 0)
                    for tag, case in results["train_graph"].items() if "valid" in case},
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

    results["variant_launches"] = _build.variant_launches()
    print(json.dumps({"train_rest": results["train_rest"], "card": card}), flush=True)
    print(json.dumps(bench_line), flush=True)
    print(json.dumps({"kernels": [entry(*k) for k in kernels]}), flush=True)
    print(json.dumps(dict(results, card=card)), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
