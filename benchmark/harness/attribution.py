"""The program's own spans over a traced stretch, and the split of the
card's idle time by them.

The port records spans where its work happens (``some_tpu_torch.utils.
profiling``: the server's handlers and dispatcher, the engine's buckets,
the trainer and its task) while ``torch.profiler`` records in its process,
on ``time.monotonic_ns``, the clock that ``DeviceTrace`` maps the device's
records onto. So a traced run's recorder holds the spans of the profiled
stretch. A reader takes them from the driver's observations
(``obs["program"]``, a ``snapshot()`` of the recorder) where a driver put
them there, else from the recorder of this process; a program without the
recorder gives None, as does a run without a traced stretch. Every reader
reads only the traced stretch [t0, t1]: the profiler's stop holds the host
for seconds after it.

:func:`idle_parts` splits the stretch's idle time by the innermost span
open on the thread that feeds the card, "no span" its own part; the parts
sum to the idle share. It takes the card's busy intervals on the host's
clock, which the trace reduction does not return yet (``PERF.md``).
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

NO_SPAN = "no span"
#: the handler's host work for a request (its wait for the batch left out)
HOST_PLANE = ("handler: read body", "handler: decode WAV", "handler: slice", "handler: reply")


def program(obs: dict) -> Optional[dict]:
    """The recorder's snapshot: the driver's, or this process's; None where
    the program has no recorder."""
    if obs.get("program") is not None:
        return obs["program"]
    try:
        from some_tpu_torch.utils import profiling
    except ImportError:
        return None
    snapshot = getattr(profiling, "snapshot", None)
    return snapshot() if snapshot is not None else None


def stretch_spans(obs: dict) -> Optional[Tuple[list, int, int]]:
    """(spans, t0, t1): the program's spans that overlap the traced
    stretch [t0, t1] (``time.monotonic_ns``); None without a stretch or
    without spans in it."""
    trace = obs.get("trace")
    snap = program(obs)
    if not trace or trace.get("t0") is None or trace.get("t1") is None or snap is None:
        return None
    t0, t1 = int(trace["t0"] * 1e9), int(trace["t1"] * 1e9)
    spans = [s for s in snap["spans"] if s["end"] > t0 and s["start"] < t1]
    return (spans, t0, t1) if spans else None


def _started_in(spans: list, name: str, t0: int, t1: int) -> list:
    return [s for s in spans if s["name"] == name and t0 <= s["start"] <= t1]


def host_plane_ms_per_audio_s(obs: dict):
    """The handlers' host work for a second of audio: for each of read
    body, decode WAV, slice and reply, the milliseconds of its spans that
    lie inside the stretch over their requests' audio seconds (the
    ``audio_s`` of each request's decode or reply span), summed. Spans that
    reach outside the stretch are left out: the profiler's start and stop,
    around it, hold the interpreter."""
    got = stretch_spans(obs)
    if got is None:
        return None
    spans, t0, t1 = got
    audio = {s["rid"]: s["attrs"]["audio_s"] for s in program(obs)["spans"]
             if s["name"].startswith("handler: ") and s["attrs"].get("audio_s")}
    total = 0.0
    for name in HOST_PLANE:
        inside = [s for s in spans if s["name"] == name and s["rid"] in audio
                  and s["start"] >= t0 and s["end"] <= t1]
        if not inside:
            return None
        total += (sum(s["end"] - s["start"] for s in inside) / 1e6
                  / sum(audio[s["rid"]] for s in inside))
    return total


def queue_wait_p50_ms(obs: dict):
    """The median time queued (``job: queued``: submit to its batch's
    ``engine.infer``) of the jobs dispatched in the stretch."""
    got = stretch_spans(obs)
    if got is None:
        return None
    spans, t0, t1 = got
    waits = [(s["end"] - s["start"]) / 1e6 for s in spans
             if s["name"] == "job: queued" and t0 <= s["end"] <= t1]
    return statistics.median(waits) if waits else None


def pad_share(obs: dict, name: str):
    """1 - real over launched (rows x frames) frames of the spans ``name``
    started in the stretch, in percent."""
    got = stretch_spans(obs)
    if got is None:
        return None
    spans, t0, t1 = got
    runs = [s["attrs"] for s in _started_in(spans, name, t0, t1) if "real_frames" in s["attrs"]]
    launched = sum(a["rows"] * a["frames"] for a in runs)
    return 100.0 * (1.0 - sum(a["real_frames"] for a in runs) / launched) if launched else None


def covered_share(obs: dict, name: str):
    """The share of the stretch covered by spans ``name``, in percent."""
    got = stretch_spans(obs)
    if got is None:
        return None
    spans, t0, t1 = got
    covered = sum(min(s["end"], t1) - max(s["start"], t0) for s in spans if s["name"] == name)
    return 100.0 * covered / (t1 - t0)


def cpu_share(obs: dict, name: str, thread: str):
    """The CPU time of ``thread``'s spans ``name`` that lie inside the
    stretch over their wall time, in percent: 100 where the thread worked
    all through them, less where it waited inside them (for the
    interpreter's lock that the other threads hold, or for the card)."""
    got = stretch_spans(obs)
    if got is None:
        return None
    spans, t0, t1 = got
    inside = [s for s in spans if s["name"] == name and s["thread"] == thread
              and s.get("cpu_ns") is not None and s["start"] >= t0 and s["end"] <= t1]
    wall = sum(s["end"] - s["start"] for s in inside)
    return 100.0 * sum(s["cpu_ns"] for s in inside) / wall if wall else None


def innermost(spans: list, thread: str, t0: int, t1: int) -> List[Tuple[int, int, str]]:
    """[t0, t1] cut into (start, end, name) pieces by the innermost span
    open on ``thread`` (spans of one thread nest; a detached span, such as a
    job's time queued, is no thread's work), ``NO_SPAN`` where none is."""
    own = sorted((s for s in spans if s["thread"] == thread and not s.get("detached")),
                 key=lambda s: (s["start"], -s["end"]))
    pieces, stack, t = [], [], t0

    def advance(until):
        nonlocal t
        while t < until:
            while stack and stack[-1]["end"] <= t:
                stack.pop()
            edge = min(until, stack[-1]["end"]) if stack else until
            if edge > t:
                pieces.append((t, edge, stack[-1]["name"] if stack else NO_SPAN))
            t = max(t, edge)

    for s in own:
        if s["end"] <= t0 or s["start"] >= t1:
            continue
        advance(max(s["start"], t0))
        stack.append(s)
    advance(t1)
    return pieces


def idle_parts(busy: List[Tuple[float, float]], spans: list, thread: str, t0: int,
               t1: int) -> Dict[str, float]:
    """{span name: percent of the stretch}: the card's idle time (the
    stretch less ``busy``, intervals in ``time.monotonic`` seconds) by the
    innermost span open on ``thread`` meanwhile, ``NO_SPAN`` its own part.
    The parts sum to the idle share."""
    idle, t = [], t0
    for a, b in sorted((int(a * 1e9), int(b * 1e9)) for a, b in busy):
        a, b = max(a, t0), min(b, t1)
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    if t < t1:
        idle.append((t, t1))
    parts: Dict[str, float] = {}
    for a, b, name in innermost(spans, thread, t0, t1):
        for c, d in idle:
            overlap = min(b, d) - max(a, c)
            if overlap > 0:
                parts[name] = parts.get(name, 0.0) + 100.0 * overlap / (t1 - t0)
    return parts
