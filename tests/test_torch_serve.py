"""The port's batch-serving HTTP API (some_tpu_torch/serve.py) against the
JAX package's serve.py, and the behaviours tests/test_serve.py holds the JAX
server to, held for the port's.

The JAX and the port servers run the same weights (tests/test_torch_engine.py's
``variables``, carried across by ``compat/from_jax``) in f32; the port runs
on the CPU. Their notes agree within the tolerances of
tests/test_torch_infer.py, and their ``format=json`` bodies have one schema.
"""
import io
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from some_tpu_torch.audio.wavio import load_wav, save_wav
from some_tpu_torch.inference.pipeline import transcribe_waveform
from some_tpu_torch.serve import BatchingDispatcher, TranscribeJob, make_server
from some_tpu_torch.utils import profiling
from tests.test_inference import synth
from tests.test_torch_engine import assert_notes_match, engines, variables  # noqa: F401

SR = 44100
STUB_CONFIG = {"audio_sample_rate": SR}


def start(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def servers(variables):  # noqa: F811
    """(JAX base URL, port base URL, port engine, port dispatcher)."""
    import serve as jax_serve

    jax_engine, port = engines(variables, transfer_dtype="float32")
    jax_httpd, _ = jax_serve.make_server(jax_engine, jax_engine.config, "127.0.0.1", 0,
                                         max_wait_ms=60.0)
    httpd, dispatcher = make_server(port, port.config, "127.0.0.1", 0, max_wait_ms=60.0)
    yield start(jax_httpd), start(httpd), port, dispatcher
    for server in (jax_httpd, httpd):
        server.shutdown()
        server.server_close()


def wav_bytes(wave, tmp_path, name="req.wav"):
    path = tmp_path / name
    save_wav(path, wave, SR)
    return path.read_bytes()


def post(url, body, timeout=300):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def http_error(url, body=None):
    """The HTTPError a request gets (fails if it gets none)."""
    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET")
    with pytest.raises(urllib.error.HTTPError) as info:
        urllib.request.urlopen(req, timeout=60)
    return info.value.code, info.value.read()


def raw_reply(base, request: bytes) -> bytes:
    host, port = base.removeprefix("http://").split(":")
    with socket.create_connection((host, int(port)), timeout=30) as sock:
        sock.sendall(request)
        return sock.recv(4096)


def direct_midi(engine, body):
    loaded, _ = load_wav(io.BytesIO(body), sr=SR, mono=True)
    return transcribe_waveform(engine, loaded, SR, tempo=120).serialize()


def songs():
    return [np.concatenate([synth(1.2, 440.0, seed=5), np.zeros(SR, np.float32),
                            synth(1.0, 523.25, seed=6)]),
            np.concatenate([synth(5.5, 392.0, seed=7), np.zeros(SR, np.float32),
                            synth(1.3, 330.0, seed=8)])]


def test_json_bodies_match_the_jax_server(servers, tmp_path):
    jax_base, base, _, _ = servers
    for i, wave in enumerate(songs()):
        body = wav_bytes(wave, tmp_path, f"s{i}.wav")
        outs = []
        for url in (jax_base, base):
            status, ctype, payload = post(url + "/transcribe?tempo=97&format=json", body)
            assert status == 200 and ctype == "application/json"
            outs.append(json.loads(payload))
        want, got = outs
        assert set(got) == set(want) == {"segments", "tempo"} and got["tempo"] == 97.0
        assert len(got["segments"]) == len(want["segments"]) >= 1
        for g, w in zip(got["segments"], want["segments"]):
            assert set(g) == set(w) == {"offset_sec", "note_midi", "note_dur_sec", "note_rest"}
            assert g["offset_sec"] == w["offset_sec"]
        assert_notes_match(
            [{"note_midi": np.array(s["note_midi"]), "note_dur": np.array(s["note_dur_sec"]),
              "note_rest": np.array(s["note_rest"])} for s in got["segments"]],
            [{"note_midi": np.array(s["note_midi"]), "note_dur": np.array(s["note_dur_sec"]),
              "note_rest": np.array(s["note_rest"])} for s in want["segments"]])


def test_healthz_and_stats(servers):
    _, base, _, _ = servers
    with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
        assert json.loads(resp.read())["status"] == "ok"
    with urllib.request.urlopen(base + "/stats", timeout=60) as resp:
        assert {"requests", "batches", "infer_rtf", "wire"} <= set(json.loads(resp.read()))
    assert http_error(base + "/nowhere")[0] == 404


def test_transcribe_matches_the_direct_engine(servers, tmp_path):
    _, base, engine, _ = servers
    body = wav_bytes(songs()[0], tmp_path)
    status, ctype, midi = post(base + "/transcribe?tempo=120", body)
    assert status == 200 and ctype == "audio/midi" and midi[:4] == b"MThd"
    assert midi == direct_midi(engine, body)


def test_concurrent_requests_batch_and_agree(servers, tmp_path):
    _, base, engine, dispatcher = servers
    bodies = [wav_bytes(synth(0.9, 300 + 60 * i, seed=20 + i), tmp_path, f"c{i}.wav")
              for i in range(4)]
    results = [None] * 4

    def call(i):
        results[i] = post(base + "/transcribe?tempo=120", bodies[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for i, (status, _, midi) in enumerate(results):
        assert status == 200, i
        assert midi == direct_midi(engine, bodies[i]), f"caller {i} got someone else's notes"
    assert dispatcher.snapshot()["max_jobs_per_batch"] >= 2


def test_a_request_spans_and_the_bucket_counts(servers, tmp_path):
    """One request with the recorder on: its handler spans share one
    request id, its job's time queued and the dispatcher's and engine's
    spans carry it; /stats has ``buckets``, whose forwards sum to the
    engine's and whose launched frames are rows x frames."""
    _, base, engine, _ = servers
    body = wav_bytes(songs()[1], tmp_path)  # two chunks of two frame buckets
    profiling.enable()
    try:
        assert post(base + "/transcribe?tempo=120&format=json", body)[0] == 200
        # the reply span closes after its bytes are written, so after the client has them
        deadline = time.monotonic() + 30
        while not any(s["name"] == "handler: reply" for s in profiling.snapshot()["spans"]):
            assert time.monotonic() < deadline, "the reply span never closed"
            time.sleep(0.01)
    finally:
        profiling.disable()
    spans = profiling.snapshot()["spans"]
    handler = [s for s in spans if s["name"].startswith("handler: ")]
    assert {s["name"] for s in handler} == {"handler: read body", "handler: decode WAV",
                                            "handler: slice", "handler: wait",
                                            "handler: reply"}
    (rid,) = {s["rid"] for s in handler}
    (decoded,) = [s for s in handler if s["name"] == "handler: decode WAV"]
    (replied,) = [s for s in handler if s["name"] == "handler: reply"]
    assert decoded["attrs"]["audio_s"] == replied["attrs"]["audio_s"] == pytest.approx(
        len(songs()[1]) / SR)
    (queued,) = [s for s in spans if s["name"] == "job: queued"]
    assert queued["rid"] == rid and queued["detached"] and queued["attrs"]["chunks"] == 2
    (infer,) = [s for s in spans if s["name"] == "dispatcher: infer"]
    assert infer["rid"] == (rid,) and infer["thread"] == "serve-dispatcher"
    assert queued["end"] <= infer["start"]
    inside = [s for s in spans if s["name"].startswith("engine: ")]
    assert {s["name"] for s in inside} == {"engine: bucket and wire-encode", "engine: stage",
                                           "engine: launch", "engine: fetch", "engine: assemble"}
    assert all(s["rid"] == (rid,) and infer["start"] <= s["start"] <= s["end"] <= infer["end"]
               for s in inside)
    launches = [s["attrs"] for s in inside if s["name"] == "engine: launch"]
    assert len(launches) == 2 and all(a["dispatch"] == "eager" for a in launches)
    assert all(0 < a["real_frames"] <= a["rows"] * a["frames"] for a in launches)
    assert {s["name"] for s in spans if s["parent"] == infer["id"]} - {"python: gc"} == {
        s["name"] for s in inside}
    with urllib.request.urlopen(base + "/stats", timeout=60) as resp:
        stats = json.loads(resp.read())
    buckets = stats["buckets"]
    assert sum(b["forwards"] for b in buckets) == engine.forwards > 0
    assert all(b["forwards"] == b["eager"] and b["replay"] == b["capture"] == 0
               and b["launched_frames"] == b["forwards"] * b["rows"] * b["frames"]
               and b["real_frames"] <= b["launched_frames"] and b["replica"] == 0
               for b in buckets)
    for a in launches:
        (b,) = [b for b in buckets if (b["rows"], b["frames"]) == (a["rows"], a["frames"])]
        assert b["real_frames"] >= a["real_frames"]


def test_bad_requests_are_400_and_oversize_413(servers):
    _, base, _, _ = servers
    code, body = http_error(base + "/transcribe?tempo=120", b"definitely not a wav")
    assert code == 400 and b"corrupt" in body
    reply = raw_reply(base, b"POST /transcribe?tempo=120 HTTP/1.1\r\nHost: test\r\n"
                            b"Content-Length: -1\r\n\r\n")
    assert b"400" in reply.split(b"\r\n", 1)[0]
    # no body sent: the server answers from the header alone
    reply = raw_reply(base, b"POST /transcribe?tempo=120 HTTP/1.1\r\nHost: test\r\n"
                            b"Content-Length: 999999999999\r\n\r\n")
    assert b"413" in reply.split(b"\r\n", 1)[0]


@pytest.mark.parametrize("tempo", ["0", "-5", "abc", "nan"])
def test_bad_tempo_is_400(servers, tmp_path, tempo):
    _, base, _, _ = servers
    code, body = http_error(base + f"/transcribe?tempo={tempo}",
                            wav_bytes(synth(0.3, 440.0, seed=1), tmp_path))
    assert code == 400 and b"tempo" in body


def no_notes(waveforms):
    return [{"note_midi": np.zeros(0), "note_dur": np.zeros(0),
             "note_rest": np.zeros(0, bool)} for _ in waveforms]


class GatedEngine:
    """An engine whose infer waits for ``release`` (a stalled device)."""
    max_batch_chunks = 8

    def __init__(self):
        self.release = threading.Event()
        self.calls = []

    def infer(self, waveforms):
        self.calls.append(len(waveforms))
        self.release.wait(timeout=30)
        return no_notes(waveforms)


class InstantEngine:
    max_batch_chunks = 8

    def infer(self, waveforms):
        return no_notes(waveforms)


class FailingEngine:
    max_batch_chunks = 8

    def infer(self, waveforms):
        raise RuntimeError("device on fire")


def test_stalled_backend_is_503_not_a_hang(tmp_path):
    engine = GatedEngine()
    httpd, dispatcher = make_server(engine, STUB_CONFIG, "127.0.0.1", 0, max_wait_ms=1.0,
                                    infer_timeout_s=0.5)
    base = start(httpd)
    try:
        code, body = http_error(base + "/transcribe",
                                wav_bytes(synth(0.3, 440.0, seed=2), tmp_path))
        assert code == 503 and b"stalled" in body
        deadline = time.monotonic() + 20
        while True:
            try:
                urllib.request.urlopen(base + "/healthz", timeout=60)
            except urllib.error.HTTPError as err:
                assert err.code == 503
                health = json.loads(err.read())
                break
            assert time.monotonic() < deadline, "healthz never reported the stall"
            time.sleep(0.1)
        assert health["status"] == "stalled" and health["busy_seconds"] > 0
        # when the hung call returns, the 503'd job counts as abandoned
        engine.release.set()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not dispatcher.snapshot()["abandoned_requests"]:
            time.sleep(0.05)
        stats = dispatcher.snapshot()
        assert stats["abandoned_requests"] == 1
        assert stats["requests"] == 0 and stats["audio_seconds"] == 0.0
    finally:
        engine.release.set()
        httpd.shutdown()
        httpd.server_close()


def test_full_queue_is_429(tmp_path):
    engine = GatedEngine()
    dispatcher = BatchingDispatcher(engine, max_wait_ms=1.0, max_queue_jobs=1)
    try:
        wave = np.zeros(16, np.float32)
        assert dispatcher.submit(TranscribeJob([wave], [0.0], 120.0))
        deadline = time.monotonic() + 10
        while dispatcher.queue_depth() and time.monotonic() < deadline:
            time.sleep(0.01)  # drained into the hung infer
        assert dispatcher.submit(TranscribeJob([wave], [0.0], 120.0))
        assert not dispatcher.submit(TranscribeJob([wave], [0.0], 120.0)), \
            "a queue over capacity must refuse"
    finally:
        engine.release.set()

    # through HTTP: a server whose one queue slot is taken answers 429
    engine = GatedEngine()
    httpd, dispatcher = make_server(engine, STUB_CONFIG, "127.0.0.1", 0, max_wait_ms=1.0)
    dispatcher.jobs.maxsize = 1
    base = start(httpd)
    try:
        assert dispatcher.submit(TranscribeJob([np.zeros(16, np.float32)], [0.0], 120.0))
        deadline = time.monotonic() + 10
        while dispatcher.queue_depth() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert dispatcher.submit(TranscribeJob([np.zeros(16, np.float32)], [0.0], 120.0))
        code, body = http_error(base + "/transcribe",
                                wav_bytes(synth(0.3, 440.0, seed=2), tmp_path))
        assert code == 429 and b"overloaded" in body
    finally:
        engine.release.set()
        httpd.shutdown()
        httpd.server_close()


def test_failed_jobs_do_not_inflate_rtf(tmp_path):
    httpd, dispatcher = make_server(FailingEngine(), STUB_CONFIG, "127.0.0.1", 0,
                                    max_wait_ms=1.0)
    base = start(httpd)
    try:
        code, body = http_error(base + "/transcribe",
                                wav_bytes(synth(0.4, 440.0, seed=3), tmp_path))
        assert code == 500 and b"device on fire" in body
        stats = dispatcher.snapshot()
        assert stats["failed_requests"] == 1
        assert stats["audio_seconds"] == 0.0 and stats["infer_rtf"] == 0.0
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_job_resolution_claim_is_atomic():
    for _ in range(200):
        job = TranscribeJob([], [], 120.0)
        winners = []
        barrier = threading.Barrier(3)

        def claim(outcome):
            barrier.wait()
            if job.resolve(outcome):
                winners.append(outcome)

        threads = [threading.Thread(target=claim, args=(o,))
                   for o in ("abandoned", "delivered", "failed")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert len(winners) == 1 and job.resolution == winners[0]
        assert not job.resolve("delivered") and job.resolution == winners[0]


def test_fast_lane_skips_the_batching_wait():
    wave = np.zeros(16, np.float32)
    fast = BatchingDispatcher(InstantEngine(), max_wait_ms=1500.0, fast_lane=True)
    job = TranscribeJob([wave], [0.0], 120.0)
    t0 = time.monotonic()
    assert fast.submit(job) and job.done.wait(timeout=10)
    assert time.monotonic() - t0 < 1.0, "the fast lane must not wait the 1.5 s window"

    slow = BatchingDispatcher(InstantEngine(), max_wait_ms=400.0, fast_lane=False)
    job = TranscribeJob([wave], [0.0], 120.0)
    t0 = time.monotonic()
    assert slow.submit(job) and job.done.wait(timeout=10)
    assert time.monotonic() - t0 >= 0.35, "without the fast lane a lone job waits the window"


def test_fast_lane_still_batches_bursts():
    engine = GatedEngine()
    dispatcher = BatchingDispatcher(engine, max_wait_ms=25.0, fast_lane=True)
    wave = np.zeros(16, np.float32)
    first = TranscribeJob([wave], [0.0], 120.0)
    assert dispatcher.submit(first)  # fast-laned into the gated infer
    deadline = time.monotonic() + 10
    while not engine.calls and time.monotonic() < deadline:
        time.sleep(0.01)
    burst = [TranscribeJob([wave], [0.0], 120.0) for _ in range(3)]
    for job in burst:
        assert dispatcher.submit(job)
    engine.release.set()
    for job in burst + [first]:
        assert job.done.wait(timeout=10)
    assert engine.calls[0] == 1 and 3 in engine.calls, engine.calls


@pytest.mark.parametrize("engine_cls", [InstantEngine, FailingEngine])
def test_recycle_after_flips_healthz(tmp_path, engine_cls):
    """After N requests that reached the device, delivered or failed,
    /healthz answers 503 recycle while requests are still served."""
    httpd, _ = make_server(engine_cls(), STUB_CONFIG, "127.0.0.1", 0, max_wait_ms=1.0,
                           recycle_after=2)
    base = start(httpd)
    body = wav_bytes(synth(0.3, 440.0, seed=3), tmp_path)
    want = 200 if engine_cls is InstantEngine else 500

    def transcribe():
        try:
            return post(base + "/transcribe?tempo=120", body)[0]
        except urllib.error.HTTPError as err:
            return err.code

    try:
        assert transcribe() == want
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            assert json.loads(resp.read())["status"] == "ok"
        assert transcribe() == want
        code, health = http_error(base + "/healthz")
        health = json.loads(health)
        assert code == 503 and health["status"] == "recycle" and health["requests"] == 2
        assert transcribe() == want
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_cli_needs_a_card_and_one_device(monkeypatch, tmp_path, variables):  # noqa: F811
    """--devices above the cards present raises; --device cpu --devices 2
    serves an engine of two replicas; no card and no --device raises."""
    import yaml

    from some_tpu.training.checkpoint import save_checkpoint
    from some_tpu_torch import serve
    from tests.test_torch_infer import CONFIG

    main = serve.main
    n = max(4, torch.cuda.device_count() + 1)
    with pytest.raises(RuntimeError, match=f"not present \\({torch.cuda.device_count()} CUDA"):
        main(["--model", str(tmp_path / "model.pt"), "--devices", str(n)])

    class Stopped:
        """A server whose serve_forever returns at once."""
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            pass

        def server_close(self):
            pass

    served = []

    def make_stopped_server(engine, *args, **kwargs):
        served.append(engine)
        return Stopped(), None

    monkeypatch.setattr(serve, "make_server", make_stopped_server)
    ckpt = save_checkpoint(tmp_path, 1000, variables["params"], variables["batch_stats"])
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(CONFIG))
    main(["--model", str(ckpt), "--device", "cpu", "--devices", "2", "--port", "0"])
    engine, = served
    assert [r.device.type for r in engine.replicas] == ["cpu", "cpu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "config.yaml").write_text("task_cls: training.MIDIExtractionTask\n"
                                          "hop_size: 512\naudio_sample_rate: 44100\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--model", str(tmp_path / "model.pt")])
