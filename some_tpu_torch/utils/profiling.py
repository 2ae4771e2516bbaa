"""Tracing: the program's own spans and counters, and torch.profiler.

**The recorder.** :func:`span` marks where the work happens (the server's
handlers and dispatcher, the engine's buckets, the trainer and its data
wait): each span holds its name, start and end on ``time.monotonic_ns``,
the CPU time its thread spent inside it (``time.thread_time_ns``: a span
whose wall time far exceeds it waited, for a lock, the interpreter or the
card), the thread's native id and name, its parent (the innermost span
open on the same thread), a request or job id (a span without one takes
its parent's) and a few attributes. Spans are kept in memory, the newest
``MAX_SPANS`` of them; older ones are counted as dropped. The recorder
records while it is switched on (:func:`enable`, :func:`disable`) and
while ``torch.profiler`` records in this process, so that a profile of the
process carries the program's spans (``record_function`` ranges would not:
a range opened on another thread than the profiler's never reaches its
records). While it records it also records each Python garbage collection
as a span (``python: gc``, with its generation). Off, a span site costs one
test of two flags and allocates nothing. :func:`snapshot` returns what was
recorded; :func:`dump` writes it as a Chrome trace (Perfetto reads it), on
the wall clock that torch.profiler's traces are written on, through a
(wall, monotonic) anchor pair taken at :func:`enable` and another at the
dump.

**torch.profiler.** :func:`trace` records the host and the device (CPU and
CUDA activities) into a trace file in ``log_dir`` that TensorBoard's
profiler plugin and Perfetto read (``<host>_<pid>.<time>.pt.trace.json``),
the program's spans of the traced block merged in; the counterpart of
``some_tpu/utils/profiling.py``'s ``trace``. The JAX module's ``RtfMeter``
has no caller there, so it is not carried over; its ``start_server`` (a
live ``jax.profiler`` endpoint) has no counterpart in torch.

:func:`graph_kernel_nodes` counts the kernels of a captured CUDA graph from
the graph itself (torch.profiler loses records of replays now and then), and
:func:`hand_written_nodes` names the hand-written ones by their wrapper.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import gc
import itertools
import json
import os
import pathlib
import socket
import threading
import time
from typing import Dict, Optional

from torch.autograd import profiler as _torch_profiler

#: the most spans the recorder keeps: the newest; it counts the older ones
#: as dropped
MAX_SPANS = 1 << 17


def _anchor() -> tuple:
    """(wall ns, monotonic ns) read together: the pair that maps the spans'
    clock onto the wall clock that torch.profiler's traces are stamped on."""
    return time.time_ns(), time.monotonic_ns()


class Span:
    """One span: a context manager that records itself when it closes.
    ``attrs`` may be filled while it is open (``if sp: sp.attrs[...] = ...``:
    a span site's answer while the recorder is off is false)."""

    __slots__ = ("name", "rid", "attrs", "start", "end", "cpu", "id", "parent", "tid",
                 "thread", "detached")

    def __init__(self, name: str, rid=None):
        self.name, self.rid, self.attrs, self.detached, self.cpu = name, rid, {}, False, None

    def __enter__(self) -> "Span":
        stack = _open_spans()
        top = stack[-1] if stack else None
        self.parent = None if top is None else top.id
        if self.rid is None and top is not None:
            self.rid = top.rid
        self.id = next(_REC.ids)
        stack.append(self)
        self.start = time.monotonic_ns()
        self.cpu = time.thread_time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.cpu = time.thread_time_ns() - self.cpu
        self.end = time.monotonic_ns()
        stack = _open_spans()
        if stack and stack[-1] is self:
            stack.pop()
        _REC.keep(self)
        return False


class _Off:
    """What a span site gets while the recorder is off: a false, shared
    context manager that does nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False


_OFF = _Off()


class _Recorder:
    """The process's spans, counters and clock anchors."""

    def __init__(self):
        self.on = False
        self.lock = threading.RLock()
        self.local = threading.local()
        self.ids = itertools.count(1)
        self.gc_hooked = False
        self.gc_start: Optional[tuple] = None
        self.clear()

    def clear(self) -> None:
        self.spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
        self.counters: Dict[str, int] = {"spans_dropped": 0, "gc_collections": 0}
        self.anchors = [_anchor()]

    def keep(self, sp: Span) -> None:
        sp.tid = threading.get_native_id()
        sp.thread = threading.current_thread().name
        with self.lock:
            if len(self.spans) == self.spans.maxlen:
                self.counters["spans_dropped"] += 1
            self.spans.append(sp)
        self.hook_gc()

    def hook_gc(self) -> None:
        """Put :func:`_on_gc` among ``gc.callbacks`` once; off, it returns
        at its first test."""
        if not self.gc_hooked:
            self.gc_hooked = True
            gc.callbacks.append(_on_gc)


_REC = _Recorder()


def _open_spans() -> list:
    stack = getattr(_REC.local, "stack", None)
    if stack is None:
        stack = _REC.local.stack = []
    return stack


#: torch.profiler's flag, set while a profile records (``torch.autograd.
#: profiler``; read where it is, never raising if a release renames it:
#: ``tests/test_torch_recorder.py::test_records_while_torch_profiler_records``
#: holds the installed torch to it)
PROFILER_FLAG = "_is_profiler_enabled"


def recording() -> bool:
    """Whether span sites record now: the recorder is on, or torch.profiler
    records in this process."""
    return _REC.on or getattr(_torch_profiler, PROFILER_FLAG, False)


def span(name: str, rid=None):
    """A span around a ``with`` block, recorded when the block ends (a
    false no-op while nothing records). ``rid``: the request or job id (by
    default the parent span's)."""
    if not (_REC.on or getattr(_torch_profiler, PROFILER_FLAG, False)):
        return _OFF
    return Span(name, rid)


def _closed(name: str, start_ns: int, end_ns: int, rid, parent, attrs: dict) -> Span:
    sp = Span(name, rid)
    sp.attrs.update(attrs)
    sp.id, sp.parent, sp.start, sp.end = next(_REC.ids), parent, int(start_ns), int(end_ns)
    return sp


def record(name: str, start_ns: int, end_ns: int, rid=None, **attrs) -> None:
    """A detached span of given bounds on ``time.monotonic_ns``: what no
    block of one thread spans, such as a job's wait in a queue (it is no
    thread's work, has no parent, and a dump writes it as an async event).
    Callers test :func:`recording` first."""
    sp = _closed(name, start_ns, end_ns, rid, None, attrs)
    sp.detached = True
    _REC.keep(sp)


def _on_gc(phase: str, info: dict) -> None:
    """``gc.callbacks``: each collection as a ``python: gc`` span."""
    if not (_REC.on or getattr(_torch_profiler, PROFILER_FLAG, False)):
        _REC.gc_start = None
        return
    if phase == "start":
        _REC.gc_start = (time.monotonic_ns(), info.get("generation"))
    elif _REC.gc_start is not None:
        start, generation = _REC.gc_start
        _REC.gc_start = None
        stack = _open_spans()
        _REC.keep(_closed("python: gc", start, time.monotonic_ns(), None,
                          stack[-1].id if stack else None,
                          {"generation": generation, "collected": info.get("collected", 0)}))
        with _REC.lock:
            _REC.counters["gc_collections"] += 1


def enable() -> None:
    """Switch the recorder on, its spans and counters cleared."""
    with _REC.lock:
        _REC.clear()
        _REC.on = True
    _REC.hook_gc()


def disable() -> None:
    """Switch the recorder off; what it recorded stays for :func:`snapshot`
    and :func:`dump`."""
    _REC.on = False


def snapshot() -> dict:
    """What the recorder holds: ``spans`` (dicts: name, start and end in
    ``time.monotonic_ns``, cpu_ns (the thread's CPU time inside the span;
    None for a detached or a ``python: gc`` span), id, parent, rid, tid
    (the thread's native id), thread (its name), detached, attrs; in the
    order they closed),
    ``counters`` (``spans_dropped`` and ``gc_collections`` among them) and
    the clock ``anchors`` ((wall ns, monotonic ns) pairs)."""
    with _REC.lock:
        spans = list(_REC.spans)
        counters = dict(_REC.counters)
        anchors = list(_REC.anchors)
    return {"spans": [{"name": s.name, "start": s.start, "end": s.end, "cpu_ns": s.cpu,
                       "id": s.id, "parent": s.parent, "rid": s.rid, "tid": s.tid, "thread": s.thread,
                       "detached": s.detached, "attrs": dict(s.attrs)} for s in spans],
            "counters": counters, "anchors": anchors}


def _to_wall(anchors: list):
    """monotonic ns -> wall ns, linear between the first and last anchor
    pairs (the two clocks drift apart slowly)."""
    (w0, m0), (w1, m1) = anchors[0], anchors[-1]
    if m1 == m0:
        return lambda t: t + (w0 - m0)
    slope = ((w1 - m1) - (w0 - m0)) / (m1 - m0)
    return lambda t: t + (w0 - m0) + slope * (t - m0)


def _chrome_events(spans: list, anchors: list, base_ns: int = 0) -> list:
    """Chrome-trace events of ``spans``: one complete event (``X``) a
    span, a pair of async events (``b``, ``e``) a detached one, ``ts`` and
    ``dur`` in microseconds from ``base_ns`` on the wall clock, and the
    threads' names (``M``)."""
    wall, pid = _to_wall(anchors), os.getpid()
    events, names = [], {}
    for s in spans:
        args = {"id": s["id"], "parent": s["parent"], **s["attrs"]}
        if s["cpu_ns"] is not None:
            args["cpu_us"] = s["cpu_ns"] / 1e3
        if s["rid"] is not None:
            args["rid"] = list(s["rid"]) if isinstance(s["rid"], tuple) else s["rid"]
        event = {"cat": "some_tpu_torch", "name": s["name"], "pid": pid, "tid": s["tid"],
                 "ts": (wall(s["start"]) - base_ns) / 1e3, "args": args}
        if s["detached"]:
            end = dict(event, ph="e", ts=(wall(s["end"]) - base_ns) / 1e3)
            events += [dict(event, ph="b", id=s["id"]), dict(end, id=s["id"])]
        else:
            events.append(dict(event, ph="X", dur=(s["end"] - s["start"]) / 1e3))
        names[s["tid"]] = s["thread"]
    events += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": name}} for tid, name in names.items()]
    return events


def dump(path) -> pathlib.Path:
    """Write what the recorder holds to ``path`` as a Chrome trace (JSON,
    ``ts`` in microseconds on the wall clock), its counters under
    ``otherData``."""
    with _REC.lock:
        _REC.anchors.append(_anchor())
    snap = snapshot()
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": _chrome_events(snap["spans"], snap["anchors"]),
                                "displayTimeUnit": "ms",
                                "otherData": {"some_tpu_torch": snap["counters"]}}))
    return path


#: (substring of a hand-written kernel's name, its wrapper), first match wins;
#: K1's weight gradient is a partials kernel and a reduce kernel, counted once
HAND_WRITTEN = (("flash_fwd_stats", "flash_attention_fwd_res"),
                ("flash_fwd", "flash_attention"), ("flash_bwd_dkv", "flash_attention_bwd_dkv"),
                ("flash_bwd_dq", "flash_attention_bwd_dq"),
                ("splash_fwd", "splash_attention"),
                ("splash_bwd_dkv", "splash_attention_bwd_dkv"),
                ("splash_bwd_dq", "splash_attention_bwd_dq"),
                ("fused_ffn", "fused_ln_ffn_residual"),
                ("depthwise_dw_partial", "depthwise_conv1d_dw"), ("depthwise_dw_reduce", None),
                ("depthwise_fwd", "depthwise_conv1d"),
                ("replica_max", "replica_max"))
#: K1's forward kernel reads its taps reversed for dx: its last argument
#: (``flip``, csrc/depthwise_conv.cu) is the seventh
_DEPTHWISE_FLIP_ARG = 6
_KERNEL_NODE = 0  # CU_GRAPH_NODE_TYPE_KERNEL


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.POINTER(ctypes.c_void_p)),
                ("extra", ctypes.POINTER(ctypes.c_void_p)), ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


def _driver():
    driver = ctypes.CDLL("libcuda.so.1")
    for name, args in (("cuGraphGetNodes", (ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.POINTER(ctypes.c_size_t))),
                       ("cuGraphNodeGetType", (ctypes.c_void_p, ctypes.POINTER(ctypes.c_int))),
                       ("cuGraphKernelNodeGetParams_v2",
                        (ctypes.c_void_p, ctypes.POINTER(_KernelNodeParams))),
                       ("cuFuncGetName", (ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p)),
                       ("cuKernelGetName", (ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p))):
        fn = getattr(driver, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return driver


def _check(err: int, call: str) -> None:
    if err != 0:
        raise RuntimeError(f"{call}: CUDA driver error {err}")


def graph_kernel_nodes(graph) -> Dict[str, int]:
    """The kernel nodes of a captured ``torch.cuda.CUDAGraph`` (made with
    ``keep_graph=True``) by kernel name, read through the CUDA driver: what
    each replay launches. A node of K1's forward kernel that reads its taps
    reversed (dx) is counted under its name + `` [flip]``."""
    driver = _driver()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    _check(driver.cuGraphGetNodes(handle, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    _check(driver.cuGraphGetNodes(handle, ctypes.cast(nodes, ctypes.c_void_p),
                                  ctypes.byref(count)), "cuGraphGetNodes")
    counts: Dict[str, int] = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        _check(driver.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != _KERNEL_NODE:
            continue
        params = _KernelNodeParams()
        _check(driver.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(params)),
               "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params.func:
            _check(driver.cuFuncGetName(ctypes.byref(name), params.func), "cuFuncGetName")
        else:
            _check(driver.cuKernelGetName(ctypes.byref(name), params.kern), "cuKernelGetName")
        label = name.value.decode()
        if "depthwise_fwd" in label:
            flip = ctypes.cast(params.kernel_params[_DEPTHWISE_FLIP_ARG],
                               ctypes.POINTER(ctypes.c_int)).contents.value
            if flip:
                label += " [flip]"
        counts[label] = counts.get(label, 0) + 1
    return counts


def hand_written_nodes(graph, training: bool) -> Dict[str, int]:
    """The hand-written kernels among ``graph_kernel_nodes(graph)`` by their
    wrapper's name, as the wrappers count their launches: in a train step's
    graph K1's reversed forward is ``depthwise_conv1d_dx`` and the splash
    forward (one kernel with and without its log-sum-exp) is
    ``splash_attention_fwd_res``."""
    out: Dict[str, int] = {}
    for label, n in graph_kernel_nodes(graph).items():
        name = next((w for key, w in HAND_WRITTEN if key in label), None)
        if name is None:  # not hand-written, or K1's reduce
            continue
        if name == "depthwise_conv1d" and label.endswith(" [flip]"):
            name = "depthwise_conv1d_dx"
        elif name == "splash_attention" and training:
            name = "splash_attention_fwd_res"
        out[name] = out.get(name, 0) + n
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace what runs inside the block; the device's work is waited for
    before the trace is written. The program's spans of the block, recorded
    while the profiler runs, are written into the same file on its clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    written = []

    def write(prof):  # tensorboard_trace_handler's file name
        name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 1_000_000}.pt.trace.json"
        prof.export_chrome_trace(str(log_dir / name))
        written.append(log_dir / name)

    first = _anchor()
    with profile(activities=activities, on_trace_ready=write):
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    last = _anchor()
    spans = [s for s in snapshot()["spans"] if s["start"] >= first[1] and s["end"] <= last[1]]
    for path in written:
        data = json.loads(path.read_text())
        data["traceEvents"] += _chrome_events(spans, [first, last],
                                              int(data.get("baseTimeNanoseconds", 0)))
        path.write_text(json.dumps(data))
