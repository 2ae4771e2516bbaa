"""Tracing.

Counterpart of ``some_tpu/utils/profiling.py``'s ``trace``: it records the
host and the device (CPU and CUDA activities of ``torch.profiler``) into a
trace file in ``log_dir`` that TensorBoard's profiler plugin and Perfetto
read (``<host>_<pid>.<time>.pt.trace.json``). The JAX module's ``RtfMeter``
has no caller there, so it is not carried over; its ``start_server`` (a live
``jax.profiler`` endpoint) has no counterpart in torch.

:func:`graph_kernel_nodes` counts the kernels of a captured CUDA graph from
the graph itself (torch.profiler loses records of replays now and then), and
:func:`hand_written_nodes` names the hand-written ones by their wrapper.
"""
from __future__ import annotations

import contextlib
import ctypes
import pathlib
from typing import Dict

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
    before the trace is written."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    pathlib.Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()

