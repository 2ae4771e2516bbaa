"""Host spans of the benchmark's own, and the reduction of a device trace.

``Spans`` records (name, start, end) on the host's monotonic clock around
calls into the program's layers; the driver wraps the calls
(:func:`wrap`), the program is not edited. ``DeviceTrace`` runs
``torch.profiler`` over a stretch of the window and reduces its device
records to what the per-layer readers take: the busy time (the union of
every kernel's, copy's and fill's interval), each kernel name's count and
time, and the idle gaps, each named by the host spans that cover most of it.
"""
from __future__ import annotations

import functools
import threading
import time
from typing import Dict, List, Optional

#: the longest idle gaps and the heaviest kernels a breakdown keeps
BREAKDOWN_ENTRIES = 10
#: where a traced run's profiler starts, as a share of the window, and the
#: longest stretch it records (the reduction reads every device record)
TRACE_LEAD = 0.25
TRACE_MAX_S = 6.0


class Phases:
    """The set-up's parts and their seconds, for a line on standard error."""

    def __init__(self, t_start: float):
        self.mark = time.monotonic()
        self.seconds = {"process start": self.mark - t_start}

    def done(self, name: str) -> None:
        now = time.monotonic()
        self.seconds[name] = now - self.mark
        self.mark = now

    def line(self) -> str:
        return "| set-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in self.seconds.items())


class Spans:
    """Host spans: append-only, from any thread."""

    def __init__(self):
        self.items: List[tuple] = []

    def add(self, name: str, start: float, end: float) -> None:
        self.items.append((name, start, end, threading.get_ident()))


def wrap(owner, attr: str, spans: Spans, name: str, on_call=None) -> None:
    """Replace ``owner.attr`` by a wrapper that records a span around each
    call; ``on_call(args, kwargs, result, start)`` sees every call."""
    inner = getattr(owner, attr)

    @functools.wraps(inner)
    def wrapper(*args, **kwargs):
        start = time.monotonic()
        try:
            result = inner(*args, **kwargs)
        finally:
            spans.add(name, start, time.monotonic())
        if on_call is not None:
            on_call(args, kwargs, result, start)
        return result

    setattr(owner, attr, wrapper)


def hold(owner, attr: str, gate: threading.Lock) -> None:
    """Replace ``owner.attr`` by a wrapper that holds ``gate`` around each
    call: the calls of other threads that launch work on the card, so that
    :class:`DeviceTrace` starts and stops between two of them."""
    inner = getattr(owner, attr)

    @functools.wraps(inner)
    def held(*args, **kwargs):
        with gate:
            return inner(*args, **kwargs)

    setattr(owner, attr, held)


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


class DeviceTrace:
    """``torch.profiler`` over [start(), stop()], reduced on ``reduce``.
    ``gate``: the lock that other threads' launches hold (:func:`hold`)."""

    def __init__(self, gate: Optional[threading.Lock] = None):
        self._prof = None
        self.t0 = self.t1 = None
        self.gate = gate if gate is not None else threading.Lock()

    def _mark(self, name: str) -> int:
        import torch

        before = time.monotonic_ns()
        with torch.profiler.record_function(name):
            pass
        return before

    def warm(self) -> None:
        """One short profile of a small operation: the profiler's and
        CUPTI's first start, which takes seconds, happens here."""
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with self.gate, torch.profiler.profile(activities=acts):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        with self.gate:
            self._prof.__enter__()
            self._m0 = self._mark("bench.mark.start")
            self.t0 = time.monotonic()

    def stop(self) -> None:
        import torch

        with self.gate:
            torch.cuda.synchronize()
            self.t1 = time.monotonic()
            self._m1 = self._mark("bench.mark.stop")
            self._prof.__exit__(None, None, None)

    def reduce(self, spans: Optional[Spans] = None) -> Dict:
        """{window_s, busy_s, kernels: {name: [count, seconds]}, gaps:
        [[label, seconds]], t0, t1} over the traced window (host clock)."""
        events = self._prof.profiler.kineto_results.events()
        marks, device = {}, []
        for e in events:
            name = e.name()
            start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
            dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
            if name.startswith("bench.mark."):
                marks[name] = start
            elif str(e.device_type()).endswith("CUDA"):
                device.append((start, start + dur, name))
        # kineto's clock -> the host's monotonic clock, from the two marks
        offset = ((marks.get("bench.mark.start", self._m0) - self._m0)
                  + (marks.get("bench.mark.stop", self._m1) - self._m1)) / 2
        lo, hi = self.t0 * 1e9 + offset, self.t1 * 1e9 + offset
        kernels: Dict[str, list] = {}
        clipped = []
        for a, b, name in device:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            clipped.append((a, b))
            entry = kernels.setdefault(name, [0, 0.0])
            entry[0] += 1
            entry[1] += (b - a) / 1e9
        busy = _union(clipped)
        busy_s = sum(b - a for a, b in busy) / 1e9
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        labelled = [[_label(spans, (a - offset) / 1e9, (b - offset) / 1e9), (b - a) / 1e9]
                    for a, b in gaps[:BREAKDOWN_ENTRIES]]
        return {"window_s": self.t1 - self.t0, "busy_s": busy_s, "kernels": kernels,
                "gaps": labelled, "t0": self.t0, "t1": self.t1}


def _label(spans: Optional[Spans], a: float, b: float) -> str:
    """The host spans that cover most of [a, b], by name, or 'no span'."""
    if spans is None:
        return "host"
    cover: Dict[str, float] = {}
    for name, s, e, _ in spans.items:
        overlap = min(e, b) - max(s, a)
        if overlap > 0:
            cover[name] = cover.get(name, 0.0) + overlap
    if not cover:
        return "host: no span open (waiting for work)"
    top = sorted(cover.items(), key=lambda kv: -kv[1])[:2]
    return "host: " + ", ".join(f"{n} {100 * min(c / (b - a), 1):.0f}%" for n, c in top)


def breakdown(reduced: Dict) -> Dict:
    """The result line's ``breakdown``: the heaviest device operations and
    the longest idle gaps, in seconds."""
    ops = sorted(reduced["kernels"].items(), key=lambda kv: -kv[1][1])[:BREAKDOWN_ENTRIES]
    return {"device_ops": [[name[:120], v[1]] for name, v in ops],
            "idle_gaps": reduced["gaps"]}
