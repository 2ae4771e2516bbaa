"""The readers of the program's own spans (``harness/attribution.py``) on
synthetic observations: each reads the traced stretch alone, a program
without the recorder gives None, and the idle time split by the feeding
thread's innermost span sums to the idle share."""
from __future__ import annotations

import pytest

from benchmark.harness import attribution as A

MS = 1_000_000  # ns


def sp(name, start_ms, end_ms, rid=None, thread="serve-dispatcher", detached=False, **attrs):
    return {"name": name, "start": int(start_ms * MS), "end": int(end_ms * MS), "rid": rid,
            "thread": thread, "detached": detached, "attrs": attrs, "id": 0, "parent": None,
            "tid": 1}


def obs(spans, t0_ms=100.0, t1_ms=1000.0):
    return {"trace": {"t0": t0_ms / 1e3, "t1": t1_ms / 1e3}, "program": {"spans": spans}}


def test_host_plane_reads_each_part_inside_the_stretch():
    h = "serve-handler_0"
    spans = [
        # decoded before the stretch, answered in it: its reply counts
        sp("handler: decode WAV", 50, 60, 1, h, audio_s=20.0),
        sp("handler: reply", 300, 310, 1, h, audio_s=20.0),
        # decoded before the recorder began: the reply knows its audio
        sp("handler: reply", 320, 325, 4, h, audio_s=15.0),
        # all inside: read 2, decode 8, slice 4, reply 6 ms for 10 audio-s
        sp("handler: read body", 110, 112, 2, h),
        sp("handler: decode WAV", 112, 120, 2, h, audio_s=10.0),
        sp("handler: slice", 120, 124, 2, h), sp("handler: wait", 124, 500, 2, h),
        sp("handler: reply", 500, 506, 2, h),
        # read before the stretch began (left out), the rest inside
        sp("handler: read body", 90, 130, 3, h),
        sp("handler: decode WAV", 130, 140, 3, h, audio_s=30.0),
        sp("handler: slice", 140, 146, 3, h),
        # its reply ends after the stretch: left out
        sp("handler: reply", 990, 1500, 3, h),
    ]
    want = 2 / 10 + (8 + 10) / (10 + 30) + (4 + 6) / (10 + 30) + (10 + 5 + 6) / (20 + 15 + 10)
    assert A.host_plane_ms_per_audio_s(obs(spans)) == pytest.approx(want)
    no_reply = [s for s in spans if s["name"] != "handler: reply"]
    assert A.host_plane_ms_per_audio_s(obs(no_reply)) is None


def test_queue_wait_is_the_median_of_jobs_dispatched_in_the_stretch():
    spans = [sp("job: queued", 0, 90, 1, detached=True),  # dispatched before
             sp("job: queued", 90, 130, 2, detached=True),
             sp("job: queued", 200, 210, 3, detached=True),
             sp("job: queued", 400, 470, 4, detached=True),
             sp("job: queued", 990, 1100, 5, detached=True)]  # after
    assert A.queue_wait_p50_ms(obs(spans)) == pytest.approx(40.0)


def test_pad_share_of_the_launches_in_the_stretch():
    spans = [sp("engine: launch", 50, 60, rows=8, frames=100, real_frames=0),
             sp("engine: launch", 150, 160, rows=4, frames=512, real_frames=1536),
             sp("engine: launch", 300, 310, rows=2, frames=256, real_frames=512),
             sp("engine: launch", 400, 410)]  # no attributes: not counted
    assert A.pad_share(obs(spans), "engine: launch") == pytest.approx(
        100 * (1 - 2048 / (2048 + 512)))


def test_cpu_share_of_the_dispatchers_spans_inside_the_stretch():
    name = "engine: bucket and wire-encode"
    spans = [sp(name, 50, 150), sp(name, 200, 300), sp(name, 400, 440),
             sp(name, 500, 600, thread="serve-handler_0"),  # another thread
             sp(name, 950, 1100)]  # ends after the stretch
    for s, cpu_ms in zip(spans, (100, 60, 40, 100, 150)):
        s["cpu_ns"] = cpu_ms * MS
    assert A.cpu_share(obs(spans), name, "serve-dispatcher") == pytest.approx(100 * 100 / 140)
    assert A.cpu_share(obs(spans[:1]), name, "serve-dispatcher") is None


def test_covered_share_clips_to_the_stretch():
    spans = [sp("trainer: wait for batch", 50, 150, thread="MainThread"),
             sp("trainer: wait for batch", 500, 590, thread="MainThread"),
             sp("trainer: wait for batch", 950, 1200, thread="MainThread"),
             sp("task: train_step", 150, 500, thread="MainThread")]
    assert A.covered_share(obs(spans), "trainer: wait for batch") == pytest.approx(
        100 * (50 + 90 + 50) / 900)


def test_readers_read_this_process_recorder():
    from some_tpu_torch.utils import profiling

    profiling.enable()
    try:
        with profiling.span("trainer: wait for batch"):
            pass
    finally:
        profiling.disable()
    (s,) = [s for s in profiling.snapshot()["spans"] if s["name"] == "trainer: wait for batch"]
    got = A.covered_share({"trace": {"t0": (s["start"] - 1000) / 1e9,
                                     "t1": (s["end"] + 1000) / 1e9}}, "trainer: wait for batch")
    assert 0 < got <= 100


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    from some_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    trace_only = {"trace": {"t0": 0.1, "t1": 1.0}}
    assert A.program(trace_only) is None
    for read in (A.host_plane_ms_per_audio_s, A.queue_wait_p50_ms):
        assert read(trace_only) is None
    assert A.pad_share(trace_only, "engine: launch") is None
    assert A.covered_share(trace_only, "trainer: wait for batch") is None
    assert A.cpu_share(trace_only, "engine: bucket and wire-encode", "serve-dispatcher") is None
    assert A.covered_share({"trace": None, "program": {"spans": []}}, "x") is None


def test_idle_parts_follow_the_innermost_span_and_sum_to_the_idle_share():
    spans = [
        sp("dispatcher: wait for job", 0, 300),
        sp("dispatcher: infer", 300, 900),
        sp("engine: bucket and wire-encode", 300, 400),
        sp("engine: launch", 400, 500),
        sp("python: gc", 420, 440),
        sp("engine: fetch", 500, 800),
        sp("engine: assemble", 800, 900),
        sp("job: queued", 0, 300, detached=True),  # no thread's work
        sp("handler: slice", 0, 1000, thread="serve-handler_0"),  # another thread
    ]
    busy = [(0.45, 0.75), (0.74, 0.76), (1.5, 2.0)]  # seconds; overlapping, and outside
    parts = A.idle_parts(busy, spans, "serve-dispatcher", 100 * MS, 1000 * MS)
    want = {"dispatcher: wait for job": 200, "engine: bucket and wire-encode": 100,
            "engine: launch": 30, "python: gc": 20, "engine: fetch": 40,
            "engine: assemble": 100, A.NO_SPAN: 100}
    assert parts == pytest.approx({k: 100 * v / 900 for k, v in want.items()})
    idle_share = 100 * (1 - (0.76 - 0.45) / 0.9)
    assert sum(parts.values()) == pytest.approx(idle_share)
