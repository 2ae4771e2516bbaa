"""Served songs: the port's HTTP server under a client process's load.

Set-up: seeded weights made on the card; the serving engine built from
them (``build_inference``, the CLI's batching: ``max_batch_chunks`` rows a
bucket); the mix's songs synthesised on the card; every (rows, frames)
bucket graph that the songs' chunks can use captured (``engine.prewarm``:
the frame buckets the program's slicer gives these songs, every row bucket
up to ``max_batch_chunks``); ``serve.make_server`` on a localhost port in
this process, with one song served through it; the client process spawned.

Window: the client's closed loop sends for ``--seconds``. Every request
is timed by the client; the server's /stats counters, the engine's
forwards and each forward's bucket are read around it.

Check, once the window has closed and the program is freed: a sample of
the songs that were answered (drawn from the seed, the longest among
them) is sliced, analysed and transcribed again by the plain reference in
float32 (``benchmark/reference``), and each served reply is judged against
it (``reference/judge.py``).
"""
from __future__ import annotations

import gc
import json
import multiprocessing
import sys
import threading
import time

import numpy as np

from benchmark.harness import client
from benchmark.harness.readers import coverage_line
from benchmark.harness.songs import song_pool, wav_bytes
from benchmark.harness.trace import (
    TRACE_LEAD, TRACE_MAX_S, DeviceTrace, Phases, Spans, breakdown, hold, wrap,
)
from benchmark.harness.weights import make_weights
from benchmark.reference import judge as J
from benchmark.reference.model import MidiExtractorRef, exact_f32

def window_metrics(records: list, audio_s: list, t0: float, t_end: float):
    """(end-to-end metrics, answered, attempted, failed) of a window.
    ``records``: (song, due, sent, done, status) a request. ``serve_rtf``:
    the audio seconds of every request answered inside the window over the
    window's seconds. Attempted: the requests sent in the window."""
    answered = [r for r in records if r[4] == 200 and t0 <= r[3] <= t_end]
    attempted = [r for r in records if r[2] < t_end]
    failed = [r for r in attempted if r[4] != 200]
    e2e = {"serve_rtf": sum(audio_s[r[0]] for r in answered) / (t_end - t0)}
    return e2e, answered, attempted, failed


def _plan(mix: dict, seed: int, seconds: float, n_songs: int) -> dict:
    """The client's plan: ``clients`` in a closed loop, the songs in an
    order the seed draws."""
    if mix["loop"] != "closed":
        raise ValueError(f"the client runs closed loops; the mix asks for {mix['loop']!r}")
    rng = np.random.default_rng([int(seed), 3])
    return {"seconds": seconds, "timeout_s": 300.0, "clients": mix["clients"],
            "order": [int(i) for _ in range(64) for i in rng.permutation(n_songs)]}


def _post(port: int, body: bytes):
    """(status, reply body) of one song sent from this process."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", client.PATH, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def run(ctx) -> dict:
    import torch

    from some_tpu_torch import serve as serve_mod
    from some_tpu_torch.inference.base_infer import (
        DEFAULT_BATCH_BUCKETS, build_inference, pick_bucket,
    )
    from some_tpu_torch.inference.pipeline import slice_waveform

    cfg, mix, seed = ctx.config, ctx.mix, ctx.seed
    device = torch.device(ctx.device)
    sr, hop = cfg["audio_sample_rate"], cfg["hop_size"]
    server = mix["server"]
    chunks_cap = int(server["max_batch_chunks"])

    phases = Phases(ctx.t_start)
    weights = make_weights(cfg, seed, device)
    engine = build_inference(cfg, None, state_dict=weights, device=device,
                             max_batch_chunks=chunks_cap)
    host_weights = {k: v.cpu() for k, v in weights.items()}
    del weights
    if ctx.fault is not None:  # the tests' broken timed path
        ctx.fault(engine)
    phases.done("weights and engine")
    pool = song_pool(seed, mix, sr, device)
    bodies = [wav_bytes(samples, sr) for samples, _ in pool]
    audio_s = [seconds for _, seconds in pool]
    phases.done("songs")
    buckets = sorted({pick_bucket(len(c["waveform"]) // hop + 1, engine.frame_buckets)
                      for samples, _ in pool
                      for c in slice_waveform(samples.astype(np.float32) / 32768.0, sr)})
    rows = tuple(b for b in DEFAULT_BATCH_BUCKETS if b <= chunks_cap)
    graphs = engine.prewarm(buckets, rows=rows)
    phases.done(f"prewarm of {graphs} bucket programs (frame buckets {buckets})")

    httpd, dispatcher = serve_mod.make_server(
        engine, engine.config, "127.0.0.1", 0, max_wait_ms=float(server["max_wait_ms"]),
        fast_lane=bool(server["fast_lane"]))
    port = httpd.server_address[1]
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    shortest = int(np.argmin(audio_s))
    status, reply = _post(port, bodies[shortest])
    if status != 200:
        raise RuntimeError(f"the warm-up song was not served: {status} {reply[:500]!r}")
    phases.done("server and one song through it")

    spans = Spans()
    groups = []

    def on_groups(args, kwargs, result, start):
        for _, _, mask in result[0]:
            groups.append((start, mask.shape[0], mask.shape[1], mask.sum(axis=1)))

    wrap(engine, "infer", spans, "dispatcher: engine.infer")
    wrap(engine, "bucket_groups", spans, "engine: bucket and wire-encode", on_groups)
    wrap(engine, "dispatch_staged", spans, "engine: stage and launch")
    handler_calls = {name: getattr(serve_mod, name)
                     for name in ("load_wav", "slice_waveform", "segments_to_json")}
    wrap(serve_mod, "load_wav", spans, "handler: decode WAV")
    wrap(serve_mod, "slice_waveform", spans, "handler: slice")
    wrap(serve_mod, "segments_to_json", spans, "handler: notes to JSON")

    plan = _plan(mix, seed, ctx.seconds, len(audio_s))
    mp = multiprocessing.get_context("spawn")
    conn, child_conn = mp.Pipe()
    proc = mp.Process(target=client.main, args=(child_conn, port, bodies, plan), daemon=True)
    proc.start()
    if conn.recv() != "ready":
        raise RuntimeError("the client did not start")
    del bodies
    tracer = None
    if ctx.trace and device.type == "cuda":  # its first start takes seconds: not in the window
        # the dispatcher thread launches all of the server's work on the
        # card, inside engine.infer: the profiler starts and stops between
        # two of its calls
        gate = threading.Lock()
        hold(engine, "infer", gate)
        tracer = DeviceTrace(gate)
        tracer.warm()
    phases.done("client process" + (" and profiler warm-up" if tracer else ""))
    print(phases.line(), file=sys.stderr)

    # ---- the window ----
    s0, f0 = dispatcher.snapshot(), engine.forwards
    t0 = time.monotonic() + 0.05
    t_end = t0 + ctx.seconds
    conn.send(t0)
    setup_s = t0 - ctx.t_start
    if tracer is not None:
        _sleep_until(t0 + TRACE_LEAD * ctx.seconds)
        tracer.start()
        _sleep_until(min(tracer.t0 + TRACE_MAX_S, t_end))
        tracer.stop()
    _sleep_until(t_end)
    s1, f1 = dispatcher.snapshot(), engine.forwards
    records, replies = conn.recv()
    proc.join(timeout=60)
    if proc.is_alive():
        proc.terminate()
        proc.join()
    memory_peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
    httpd.shutdown()
    httpd.server_close()
    for name, call in handler_calls.items():  # the module as it was, for a next run
        setattr(serve_mod, name, call)

    # ---- end to end ----
    e2e, answered, attempted, failed = window_metrics(records, audio_s, t0, t_end)
    e2e["setup_s"] = setup_s
    print(f"| window: {len(attempted)} requests, {len(answered)} answered in it, "
          f"{len(failed)} failed; {f1 - f0} forwards", file=sys.stderr)

    # ---- what the per-layer readers take ----
    d = {k: s1[k] - s0[k] for k in ("requests", "batches", "audio_seconds")}
    in_window = [g for g in groups if t0 <= g[0] <= t_end]
    obs = {"window_s": ctx.seconds, "config": cfg, "dispatcher": d,
           "forwards": f1 - f0, "groups": in_window, "trace": None}
    out = {"e2e": e2e, "attempted": len(attempted), "failed": len(failed),
           "memory_peak_bytes": memory_peak, "obs": obs}
    if tracer is not None:
        reduced = tracer.reduce(spans)
        reduced["groups"] = [g for g in groups if tracer.t0 <= g[0] <= tracer.t1]
        obs["trace"] = reduced
        print(coverage_line(obs), file=sys.stderr)
        out["breakdown"] = breakdown(reduced)
        out["busy_s"], out["window_s"] = reduced["busy_s"], reduced["window_s"]

    # ---- the check: the program freed, the reference on a sample ----
    dispatcher.engine = None
    del engine, dispatcher, httpd
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    out["checks"] = _check(ctx, ctx.judge_config, mix, seed, pool, replies, records, t_end,
                           host_weights, device)
    print(f"| check: {len(ctx.readings['judged_songs'])} songs judged in "
          f"{time.monotonic() - t_check:.2f} s", file=sys.stderr)
    return out


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def _check(ctx, cfg, mix, seed, pool, replies, records, t_end, host_weights, device):
    """[(name, value, limit)] of the judged sample."""
    import torch

    errors = sum(1 for r in records if r[2] < t_end and (r[4] >= 500 or r[4] == 0))
    done = sorted(replies)
    rng = np.random.default_rng([int(seed), 4])
    pick = list(rng.choice(done, size=min(mix["judge_songs"], len(done)), replace=False))
    longest = max(done, key=lambda i: len(pool[i][0]))
    if longest not in pick:
        pick.append(longest)
    a = cfg["midi_extractor_args"]
    quant = None if str(cfg.get("quantize", "none")) == "none" else str(cfg["quantize"])
    weights = {k: v.to(device) for k, v in host_weights.items()}
    judged = {"reference": quant}
    if ctx.control:
        judged["control"] = J.CONTROL[quant]
    counts = {k: [] for k in judged}
    with exact_f32(), torch.no_grad():
        models = {k: MidiExtractorRef(weights, a["lay"], a["attention_heads"],
                                      a["attention_heads_dim"], quant=q)
                  for k, q in judged.items()}
        for i in pick:
            wave = pool[i][0].astype(np.float32) / 32768.0
            ref = J.reference_chunks(wave, cfg, models["reference"], device)
            reply = json.loads(replies[i])
            counts["reference"].append(J.judge_reply(reply, ref, cfg))
            if "control" in judged:
                control = J.reference_chunks(wave, cfg, models["control"], device)
                counts["control"].append(J.judge_reply(J.as_reply(control, cfg), ref, cfg))
    numbers = J.numbers(counts["reference"])
    limits = ctx.limits
    checks = [("server_errors", errors, 0), ("chunks_off", numbers["chunks_off"], 0),
              ("pitch_off_share", numbers["pitch_off_share"], limits["pitch_off_share"]),
              ("note_count_dev", numbers["note_count_dev"], limits["note_count_dev"])]
    if "control" in judged:
        ctx.readings["control"] = J.numbers(counts["control"])
    ctx.readings["program"] = numbers
    ctx.readings["judged_songs"] = [int(i) for i in pick]
    return checks
