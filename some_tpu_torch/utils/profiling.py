"""Tracing.

Counterpart of ``some_tpu/utils/profiling.py``'s ``trace``: it records the
host and the device (CPU and CUDA activities of ``torch.profiler``) into a
trace file in ``log_dir`` that TensorBoard's profiler plugin and Perfetto
read (``<host>_<pid>.<time>.pt.trace.json``). The JAX module's ``RtfMeter``
has no caller there, so it is not carried over; its ``start_server`` (a live
``jax.profiler`` endpoint) has no counterpart in torch.
"""
from __future__ import annotations

import contextlib
import pathlib


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

