"""Batch-serving HTTP API: WAV in, MIDI (or JSON notes) out.

Counterpart of the JAX package's ``serve.py``. A dispatcher thread
micro-batches the chunks of concurrent requests into one ``engine.infer``
call, so many small requests fill the rows of the engine's bucket graphs
instead of running one bucket each.

Endpoints
  POST /transcribe?tempo=120[&format=json]   body: WAV bytes
       -> audio/midi SMF bytes (or JSON note arrays with format=json)
  GET  /healthz  -> {"status": "ok"|"stalled"|"recycle", "queue_depth": N, ...}
  GET  /stats    -> cumulative counts: requests, batches, audio seconds;
                    ``infer_seconds``, the host's time inside ``engine.infer``
                    (bucketing, wire encoding, staging, launches, the fetch,
                    assembly) and ``infer_rtf``, audio seconds over it; per job
                    ``job_queue_wait_ms`` and ``job_infer_ms``; ``buckets``, the
                    engine's ``bucket_counts()`` (each bucket's forwards by
                    replay, capture and eager run, real and launched frames)

    python -m some_tpu_torch.serve --model CKPT [--port 8572] [--prewarm 768,1024]
        [--wire-sr 22050] [--device cpu] [--trace-out PATH]

``--trace-out PATH`` switches the program's span recorder
(``utils/profiling``) on and writes it to PATH as a Chrome trace when the
server shuts down: each request's handler spans (read body, decode WAV,
slice, wait, reply) under one request id, the dispatcher's (wait for job,
batching wait, infer, resolve, each job's time queued) and the engine's
(bucket and wire-encode, stage, launch, fetch, assemble, capture, wire
re-probe).

Stdlib only (``http.server``, argparse). Runs on the card unless
``--device cpu``; without a card it raises.
"""
from __future__ import annotations

import argparse
import io
import itertools
import json
import pathlib
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from some_tpu_torch.audio.wavio import load_wav
from some_tpu_torch.infer import load_engine, parse_buckets
from some_tpu_torch.inference.pipeline import MAX_DURATION_SEC, segments_to_json, slice_waveform
from some_tpu_torch.utils import profiling
from some_tpu_torch.utils.midi_file import build_midi_file

# Bound on the request body itself; the per-request duration gate is
# MAX_DURATION_SEC, this only bounds what the server buffers. 512 MB covers a
# 20-minute 48 kHz upload in any common encoding (float32 stereo ~460 MB);
# a float64 stereo WAV of that length (~920 MB) is refused with 413.
MAX_BODY_BYTES = 512 * 1024 * 1024
#: request ids; a request's job takes its request's
_request_ids = itertools.count(1)


class TranscribeJob:
    __slots__ = ("chunks", "offsets", "tempo", "audio_seconds", "done",
                 "segments", "error", "resolution", "_lock", "t_submit", "rid")

    def __init__(self, chunks, offsets, tempo, audio_seconds=0.0, rid=None):
        self.rid = next(_request_ids) if rid is None else rid
        self.chunks = chunks          # list of waveforms (one per slice)
        self.offsets = offsets
        self.tempo = tempo
        self.audio_seconds = audio_seconds
        self.t_submit = time.monotonic()   # stamped again by submit()
        self.done = threading.Event()
        self.segments = None
        self.error: Optional[str] = None
        # single-assignment accounting state, claimed atomically by either
        # the handler ("abandoned", on its 503 timeout) or the dispatcher
        # ("delivered"/"failed"): without the claim, a timeout landing in
        # the instant the dispatcher finishes could count one request as
        # both a 503 to the client and completed work in /stats
        self.resolution: Optional[str] = None
        self._lock = threading.Lock()

    def resolve(self, outcome: str) -> bool:
        """Claim the job's final accounting state; True iff this call won.
        The state goes None -> value exactly once."""
        with self._lock:
            if self.resolution is None:
                self.resolution = outcome
                return True
            return False


class BatchingDispatcher:
    """One consumer thread: drains queued jobs, concatenates their chunk
    lists into one ``engine.infer`` call (the engine groups chunks by frame
    bucket and batches rows), then splits the results back per job."""

    def __init__(self, engine, max_wait_ms: float = 25.0,
                 max_chunks_per_batch: Optional[int] = None,
                 max_queue_jobs: int = 256, fast_lane: bool = True):
        self.engine = engine
        self.max_wait = max_wait_ms / 1000.0
        self.max_chunks = max_chunks_per_batch or 4 * engine.max_batch_chunks
        # fast lane: a job arriving to an empty queue dispatches at once
        # instead of waiting max_wait_ms for batch-mates; a concurrent burst
        # still batches (its tail finds a non-empty queue)
        self.fast_lane = fast_lane
        # bounded: a stalled device and retrying clients must not grow an
        # unbounded backlog of waveforms (submit -> False -> HTTP 429)
        self.jobs: "queue.Queue[TranscribeJob]" = queue.Queue(max_queue_jobs)
        self.stats = {"requests": 0, "failed_requests": 0,
                      "abandoned_requests": 0, "batches": 0,
                      "audio_seconds": 0.0, "infer_seconds": 0.0,
                      "max_jobs_per_batch": 0}
        # per-job (queue wait, engine.infer) seconds, the last 2048: is a
        # slow request waiting in the queue or in its batch's infer?
        self._job_times: "deque[tuple]" = deque(maxlen=2048)
        self._lock = threading.Lock()
        self._busy_since: Optional[float] = None
        self._thread = threading.Thread(target=self._run, daemon=True, name="serve-dispatcher")
        self._thread.start()

    def submit(self, job: TranscribeJob) -> bool:
        job.t_submit = time.monotonic()
        try:
            self.jobs.put_nowait(job)
            return True
        except queue.Full:
            return False

    def queue_depth(self) -> int:
        return self.jobs.qsize()

    def busy_seconds(self) -> float:
        """How long the current ``engine.infer`` call has been running (0
        when idle): /healthz's liveness signal, so a hung device call does
        not keep reporting a healthy service."""
        with self._lock:
            return 0.0 if self._busy_since is None else time.monotonic() - self._busy_since

    def served(self) -> int:
        """Requests that reached the device: delivered, failed or abandoned."""
        with self._lock:
            return (self.stats["requests"] + self.stats["failed_requests"]
                    + self.stats["abandoned_requests"])

    def _drain(self) -> List[TranscribeJob]:
        with profiling.span("dispatcher: wait for job"):
            batch = [self.jobs.get()]  # block for the first job
        if self.fast_lane and self.jobs.empty():
            return batch
        with profiling.span("dispatcher: batching wait"):
            deadline = time.monotonic() + self.max_wait
            n_chunks = len(batch[0].chunks)
            while n_chunks < self.max_chunks:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    job = self.jobs.get(timeout=timeout)
                except queue.Empty:
                    break
                batch.append(job)
                n_chunks += len(job.chunks)
        return batch

    def _run(self) -> None:
        while True:
            batch = self._drain()
            # resolution only goes None -> value, so a job already claimed
            # "abandoned" is dropped without spending device time on it
            dropped = [job for job in batch if job.resolution == "abandoned"]
            batch = [job for job in batch if job.resolution != "abandoned"]
            if dropped:
                with self._lock:
                    self.stats["abandoned_requests"] += len(dropped)
            if not batch:
                continue
            waveforms = [w for job in batch for w in job.chunks]
            t0 = time.monotonic()
            if profiling.recording():
                for job in batch:
                    profiling.record("job: queued", round(job.t_submit * 1e9), round(t0 * 1e9),
                                     job.rid, chunks=len(job.chunks))
            with self._lock:
                self._busy_since = t0
            try:
                with profiling.span("dispatcher: infer") as sp:
                    if sp:
                        sp.rid = tuple(job.rid for job in batch)
                        sp.attrs["chunks"] = len(waveforms)
                    all_segments = self.engine.infer(waveforms)
            except Exception as exc:  # the boundary: every caller in the batch gets it
                failed = 0
                for job in batch:
                    job.error = f"{type(exc).__name__}: {exc}"
                    failed += job.resolve("failed")
                    job.done.set()
                with self._lock:
                    self._busy_since = None
                    self.stats["failed_requests"] += failed
                    self.stats["abandoned_requests"] += len(batch) - failed
                continue
            with profiling.span("dispatcher: resolve"):
                self._resolve(batch, all_segments, t0)

    def _resolve(self, batch: List[TranscribeJob], all_segments, t0: float) -> None:
        """Hand each job of a batch its segments and wake its handler."""
        elapsed = time.monotonic() - t0
        for job in batch:
            # queue wait = submit -> the batch's engine.infer began
            self._job_times.append((t0 - job.t_submit, elapsed))
        pos = 0
        delivered = []
        for job in batch:
            job.segments = all_segments[pos:pos + len(job.chunks)]
            pos += len(job.chunks)
            # claim before done.set(): a handler timing out in the same
            # instant either wins the claim (503, counted abandoned) or
            # loses it (the fields are final, it delivers)
            if job.resolve("delivered"):
                delivered.append(job)
            job.done.set()
        with self._lock:
            self._busy_since = None
            self.stats["requests"] += len(delivered)
            self.stats["abandoned_requests"] += len(batch) - len(delivered)
            self.stats["batches"] += 1
            self.stats["infer_seconds"] += elapsed
            # only completed work counts toward throughput: failed jobs
            # would inflate RTF exactly when the service is broken
            self.stats["audio_seconds"] += sum(job.audio_seconds for job in delivered)
            self.stats["max_jobs_per_batch"] = max(self.stats["max_jobs_per_batch"],
                                                   len(batch))

    def snapshot(self) -> dict:
        with self._lock:
            stats = dict(self.stats)
            times = list(self._job_times)
        stats["infer_rtf"] = (stats["audio_seconds"] / stats["infer_seconds"]
                              if stats["infer_seconds"] else 0.0)
        if times:
            waits = np.array([w for w, _ in times]) * 1e3
            infers = np.array([d for _, d in times]) * 1e3
            for key, values in (("job_queue_wait_ms", waits), ("job_infer_ms", infers)):
                stats[key] = {"p50": round(float(np.percentile(values, 50)), 1),
                              "p99": round(float(np.percentile(values, 99)), 1),
                              "max": round(float(values.max()), 1)}
        if hasattr(self.engine, "bucket_counts"):
            stats["buckets"] = self.engine.bucket_counts()
        stats["wire"] = getattr(self.engine, "wire", None)
        if getattr(self.engine, "wire_decision", None) is not None:
            # the auto wire's live decision (re-probed inside engine.infer)
            stats["wire_decision"] = self.engine.wire_decision
        return stats


class PooledHTTPServer(ThreadingHTTPServer):
    """A fixed pool of handler threads instead of a thread per connection:
    the dispatcher's queue bounds the backlog of work, this bounds the
    backlog of sockets."""

    pool_size = 32

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._pool = ThreadPoolExecutor(max_workers=self.pool_size,
                                        thread_name_prefix="serve-handler")

    def process_request(self, request, client_address):
        self._pool.submit(self.process_request_thread, request, client_address)

    def server_close(self):
        super().server_close()
        self._pool.shutdown(wait=False)


def make_server(engine, config: dict, addr: str, port: int,
                max_wait_ms: float = 25.0, infer_timeout_s: float = 600.0,
                fast_lane: bool = True, recycle_after: Optional[int] = None):
    """Build (but do not start) the HTTP server: (httpd, dispatcher).

    ``recycle_after``: after this many requests reached the device
    (delivered, failed or abandoned) /healthz answers 503
    ``{"status": "recycle"}``, so an orchestrator's liveness probe rotates
    the worker; requests in flight and after it are still served."""
    dispatcher = BatchingDispatcher(engine, max_wait_ms=max_wait_ms, fast_lane=fast_lane)
    sr = config["audio_sample_rate"]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default
            pass

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, obj) -> None:
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path.startswith("/healthz"):
                busy = dispatcher.busy_seconds()
                stalled = busy > infer_timeout_s
                served = dispatcher.served()
                recycle = not stalled and recycle_after is not None and served >= recycle_after
                status = "stalled" if stalled else "recycle" if recycle else "ok"
                self._reply_json(503 if status != "ok" else 200, {
                    "status": status, "queue_depth": dispatcher.queue_depth(),
                    "requests": served, "busy_seconds": round(busy, 1)})
            elif self.path.startswith("/stats"):
                self._reply_json(200, dispatcher.snapshot())
            else:
                self._reply_json(404, {"error": "unknown path"})

        def do_POST(self):
            if not self.path.startswith("/transcribe"):
                self._reply_json(404, {"error": "unknown path"})
                return
            params = parse_qs(urlparse(self.path).query)
            try:
                tempo = float(params.get("tempo", ["120"])[0])
                if not (0 < tempo < 10000):
                    raise ValueError
            except ValueError:
                self._reply_json(400, {"error": "tempo must be a positive number"})
                return
            as_json = params.get("format", [""])[0] == "json"
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._reply_json(400, {"error": "bad Content-Length"})
                return
            if length < 0:
                # rfile.read(-1) would block until the client closes
                self._reply_json(400, {"error": "bad Content-Length"})
                return
            if length > MAX_BODY_BYTES:
                self._reply_json(413, {"error": f"body larger than {MAX_BODY_BYTES} bytes"})
                return
            rid = next(_request_ids)
            with profiling.span("handler: read body", rid):
                body = self.rfile.read(length)
            try:
                with profiling.span("handler: decode WAV", rid) as sp:
                    waveform, _ = load_wav(io.BytesIO(body), sr=sr, mono=True)
                    if sp:
                        sp.attrs["audio_s"] = len(waveform) / sr
            except Exception:  # any decode failure of an uploaded body is the client's
                self._reply_json(400, {"error": "unsupported or corrupt wav"})
                return
            duration = len(waveform) / sr
            if duration > MAX_DURATION_SEC:
                self._reply_json(413, {"error": "audio longer than 20 min"})
                return
            with profiling.span("handler: slice", rid):
                chunk_dicts = slice_waveform(waveform, sr)
            job = TranscribeJob([c["waveform"] for c in chunk_dicts],
                                [c["offset"] for c in chunk_dicts], tempo,
                                audio_seconds=duration, rid=rid)
            if not dispatcher.submit(job):
                self._reply_json(429, {"error": "server overloaded, retry later"})
                return
            with profiling.span("handler: wait", rid):
                done = job.done.wait(timeout=infer_timeout_s)
            if not done:
                # a hung device call holds the dispatcher thread; tell the
                # caller instead of hanging the connection with it
                if job.resolve("abandoned"):
                    self._reply_json(503, {"error": "inference backend stalled"})
                    return
                # lost the claim: the dispatcher resolved the job in the
                # timeout gap and its fields are final; deliver them
            with profiling.span("handler: reply", rid) as sp:
                if sp:
                    sp.attrs["audio_s"] = duration
                if job.error is not None:
                    self._reply_json(500, {"error": job.error})
                elif as_json:
                    self._reply_json(200, segments_to_json(job.offsets, job.segments,
                                                           job.tempo))
                else:
                    midi = build_midi_file(job.offsets, job.segments, tempo=tempo)
                    self._reply(200, midi.serialize(), "audio/midi")

    httpd = PooledHTTPServer((addr, port), Handler)
    return httpd, dispatcher


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Batch-serving HTTP API: POST wav to /transcribe.")
    parser.add_argument("--model", required=True, help="checkpoint (config.yaml beside it)")
    parser.add_argument("--port", type=int, default=8572)
    parser.add_argument("--addr", default="0.0.0.0")
    parser.add_argument("--devices", type=int, default=1,
                        help="serve over a mesh of N engine replicas (cuda:0..N-1, or N on "
                             "the CPU with --device cpu)")
    parser.add_argument("--max-wait-ms", type=float, default=25.0,
                        help="micro-batching window: how long the dispatcher waits to fill a "
                             "batch after the first request arrives")
    parser.add_argument("--max-batch-chunks", type=int, default=32)
    parser.add_argument("--infer-timeout-s", type=float, default=600.0,
                        help="per-request wait on the device before replying 503; also the "
                             "/healthz stall threshold")
    parser.add_argument("--wire-sr", type=int, default=None,
                        help="decimate the audio sent to the device to this rate (e.g. 22050)")
    parser.add_argument("--fast-lane", action=argparse.BooleanOptionalAction, default=True,
                        help="dispatch a request arriving to an empty queue at once")
    parser.add_argument("--recycle-after", type=int, default=None,
                        help="after N requests /healthz answers 503 {status: recycle}")
    parser.add_argument("--prewarm", default=None, metavar="T1,T2,..",
                        help="frame buckets whose graphs to capture before answering (each at "
                             "rows 1-8), e.g. '768,1024'")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; cpu runs the plain versions)")
    parser.add_argument("--trace-out", default=None, metavar="PATH",
                        help="record the program's spans and write them to PATH as a Chrome "
                             "trace when the server shuts down")
    args = parser.parse_args(argv)
    engine = load_engine(pathlib.Path(args.model), device=args.device, quiet=True,
                         wire_sr=args.wire_sr, max_batch_chunks=args.max_batch_chunks,
                         devices=args.devices)
    if args.prewarm:
        n = engine.prewarm(parse_buckets(args.prewarm))
        print(f"| prewarmed {n} bucket programs ({args.prewarm} frames x 1..8 rows)")
    httpd, _ = make_server(engine, engine.config, args.addr, args.port,
                           max_wait_ms=args.max_wait_ms, infer_timeout_s=args.infer_timeout_s,
                           fast_lane=args.fast_lane, recycle_after=args.recycle_after)
    print(f"| serving on http://{args.addr}:{httpd.server_address[1]} "
          "(POST /transcribe, GET /healthz, /stats)", flush=True)
    if args.trace_out:
        profiling.enable()
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        if args.trace_out:
            profiling.disable()
            print(f"| spans written to {profiling.dump(args.trace_out)}", flush=True)


if __name__ == "__main__":
    main()
