"""The port's span recorder (``some_tpu_torch/utils/profiling.py``), on the CPU.

Off, a span site records and allocates nothing. On, spans nest (each holds
its parent, the innermost span open on its thread, and takes the parent's
request id when it has none), carry their thread's name, native id and
CPU time, the oldest are dropped and counted past ``MAX_SPANS``, and a
garbage collection is a span of its own. ``dump`` writes a Chrome trace on the wall clock. The
recorder also records while ``torch.profiler`` records, and ``trace``
writes the block's spans into the profiler's trace file.
"""
import gc
import json
import threading
import time
import tracemalloc

import pytest
import torch

from some_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def recorder_off():
    profiling.disable()
    yield
    profiling.disable()


def spans_named(name):
    return [s for s in profiling.snapshot()["spans"] if s["name"] == name]


def site(i):
    with profiling.span("engine: launch", i) as sp:
        if sp:
            sp.attrs["rows"] = i


def test_off_records_and_allocates_nothing():
    assert not profiling.recording()
    before = len(profiling.snapshot()["spans"])
    for i in range(100):  # warm: first calls may fill the interpreter's caches
        site(i)
    tracemalloc.start()
    try:
        first = tracemalloc.take_snapshot()
        for i in range(10_000):
            site(i)
        last = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = [tracemalloc.Filter(True, profiling.__file__)]
    grown = [d for d in last.filter_traces(mine).compare_to(first.filter_traces(mine), "lineno")
             if d.size_diff > 0 or d.count_diff > 0]
    assert grown == []
    assert len(profiling.snapshot()["spans"]) == before
    with profiling.span("off") as sp:
        assert not sp


def test_spans_nest_with_parents_and_request_ids():
    profiling.enable()
    with profiling.span("outer", 7) as outer:
        with profiling.span("inner") as inner:
            inner.attrs["rows"] = 3
        with profiling.span("sibling", 9):
            pass
    with profiling.span("after"):
        pass
    profiling.disable()
    by_name = {s["name"]: s for s in profiling.snapshot()["spans"]}
    assert [s["name"] for s in profiling.snapshot()["spans"]] == ["inner", "sibling", "outer",
                                                                  "after"]
    assert by_name["outer"]["parent"] is None and by_name["after"]["parent"] is None
    assert by_name["inner"]["parent"] == by_name["sibling"]["parent"] == outer.id
    assert by_name["inner"]["rid"] == 7 and by_name["sibling"]["rid"] == 9
    assert by_name["inner"]["attrs"] == {"rows": 3}
    o, i = by_name["outer"], by_name["inner"]
    assert o["start"] <= i["start"] <= i["end"] <= o["end"] <= by_name["after"]["start"]
    assert o["thread"] == threading.current_thread().name
    assert o["tid"] == threading.get_native_id()


def test_each_thread_nests_its_own_spans():
    profiling.enable()
    seen = {}

    def work():
        seen["tid"] = threading.get_native_id()
        with profiling.span("worker span"):
            pass

    with profiling.span("main span"):
        worker = threading.Thread(target=work, name="prefetch-x")
        worker.start()
        worker.join(timeout=30)
    assert not worker.is_alive()
    profiling.disable()
    (w,) = spans_named("worker span")
    assert w["parent"] is None and w["thread"] == "prefetch-x" and w["tid"] == seen["tid"]


def test_a_full_buffer_drops_and_counts(monkeypatch):
    """A full buffer keeps the newest spans: a long-lived process's later
    profile still records."""
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    profiling.enable()
    for i in range(5):
        with profiling.span(f"s{i}"):
            pass
    profiling.disable()
    snap = profiling.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["s2", "s3", "s4"]
    assert snap["counters"]["spans_dropped"] == 2


def test_spans_carry_their_threads_cpu_time():
    """A span's CPU time tells its thread's work from its waits."""
    profiling.enable()
    with profiling.span("waits"):
        time.sleep(0.05)
    with profiling.span("works"):
        end = time.monotonic() + 0.05
        while time.monotonic() < end:
            pass
    now = time.monotonic_ns()
    profiling.record("job: queued", now - 1000, now)
    profiling.disable()
    (waits,), (works,) = spans_named("waits"), spans_named("works")
    assert 0 <= waits["cpu_ns"] < 0.5 * (waits["end"] - waits["start"])
    wall = works["end"] - works["start"]
    assert 0.5 * wall < works["cpu_ns"] <= wall + 1_000_000  # two clocks: a little slack
    assert spans_named("job: queued")[0]["cpu_ns"] is None


def test_a_garbage_collection_is_a_span():
    profiling.enable()
    with profiling.span("outer") as outer:
        gc.collect()
    profiling.disable()
    collections = [s for s in spans_named("python: gc") if s["attrs"]["generation"] == 2]
    assert collections and collections[-1]["parent"] == outer.id
    assert profiling.snapshot()["counters"]["gc_collections"] >= 1


def test_dump_writes_a_chrome_trace_on_the_wall_clock(tmp_path):
    profiling.enable()
    wall_before = time.time_ns()
    with profiling.span("handler: slice", 4):
        time.sleep(0.01)
    now = time.monotonic_ns()
    profiling.record("job: queued", now - 5_000_000, now, 4, chunks=2)
    wall_after = time.time_ns()
    profiling.disable()
    path = profiling.dump(tmp_path / "spans.json")
    data = json.loads(path.read_text())
    events = data["traceEvents"]
    (x,) = [e for e in events if e.get("name") == "handler: slice"]
    assert x["ph"] == "X" and x["args"]["rid"] == 4 and x["tid"] == threading.get_native_id()
    assert wall_before / 1e3 - 1e3 <= x["ts"] <= wall_after / 1e3 and 1e4 <= x["dur"] < 1e6
    queued = [e for e in events if e.get("name") == "job: queued"]
    assert sorted(e["ph"] for e in queued) == ["b", "e"] and queued[0]["id"] == queued[1]["id"]
    ends = {e["ph"]: e["ts"] for e in queued}
    assert ends["e"] - ends["b"] == pytest.approx(5000, abs=1)
    names = {e["tid"]: e["args"]["name"] for e in events if e.get("ph") == "M"}
    assert names[x["tid"]] == threading.current_thread().name
    assert data["otherData"]["some_tpu_torch"]["spans_dropped"] == 0


def test_records_while_torch_profiler_records():
    """Also holds the installed torch to the profiler's flag that the
    recorder reads (``profiling.PROFILER_FLAG``)."""
    from torch.profiler import ProfilerActivity, profile

    assert getattr(torch.autograd.profiler, profiling.PROFILER_FLAG) is False

    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.recording()
        with profiling.span("profiled"):
            torch.ones(3).add_(1)
    assert not profiling.recording()
    with profiling.span("after the profile"):
        pass
    assert len(spans_named("profiled")) >= 1 and spans_named("after the profile") == []


def test_trace_writes_the_blocks_spans_into_its_file(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("task: train_step"):
            torch.ones(64, 64).mm(torch.ones(64, 64))
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    (step,) = [e for e in events if e.get("name") == "task: train_step"]
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    # one clock: the product lies inside the span (a few microseconds of slack)
    assert step["ts"] - 5 <= mm["ts"] and mm["ts"] + mm["dur"] <= step["ts"] + step["dur"] + 5
    assert step["tid"] == mm["tid"]
