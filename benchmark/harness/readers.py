"""Shared arithmetic of the per-layer readers (``benchmark/metrics``); shares
are in percent.

Each reader takes the driver's observations: the window's seconds, the
program's counters before and after it, every forward's bucket (rows,
padded frames, real frames a row) from the benchmark's own spans, and with
``--trace 1`` the reduced device trace of a stretch of the window (its
seconds, busy seconds, each kernel name's count and seconds, and the
forwards dispatched inside it). A reader returns None where it finds
nothing to read.
"""
from __future__ import annotations

import numpy as np

from benchmark.harness.counts import (
    MFU_PEAK, PEAK_FLOPS, attention_work, depthwise_work, least_seconds, model_flops,
)


def idle_share(obs: dict):
    """1 - the union of the device records' intervals over the traced
    stretch. None where the trace holds no device record, or where it
    recorded fewer K1 or K2 calls than were made (the profiler lost
    records, which would read as idle time)."""
    trace = obs.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    if any(rec < made - slack for rec, made, slack in coverage(obs).values()):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def blocks(config: dict) -> int:
    """Conformer blocks a forward runs: two a dual-stream layer, two final."""
    return 2 * config["midi_extractor_args"]["lay"] + 2


def coverage(obs: dict) -> dict:
    """{kernel name pattern: (recorded calls, calls made, calls that may
    run outside the stretch)} of K1 and K2 in the traced stretch. Calls
    made: the forwards (train steps) dispatched in the stretch times each
    one's calls. A served forward dispatched just before the stretch closed
    may run after it, so the calls of the stretch's last dispatch may go
    unrecorded; a train step closes the stretch after its own work."""
    trace = obs.get("trace")
    if not trace:
        return {}
    if trace.get("groups") is not None:
        n = blocks(obs["config"])
        starts = [g[0] for g in trace["groups"]]
        last = starts.count(max(starts)) if starts else 0
        per, units, slack = {"flash_fwd": n, "depthwise_fwd": n}, len(starts), last
    elif trace.get("steps") is not None:
        c = _train_calls(obs["config"])
        per = {"flash_fwd_stats": c["fwd_res"], "flash_bwd_dkv": c["bwd_dkv"],
               "flash_bwd_dq": c["bwd_dq"], "depthwise_fwd": c["dw_fwd"],
               "depthwise_dw_partial": c["dw_dw"]}
        units, slack = len(trace["steps"]), 0
    else:
        return {}
    return {pattern: (kernel_calls(trace, pattern)[0], k * units, k * slack)
            for pattern, k in per.items()}


def coverage_line(obs: dict) -> str:
    """Recorded against made calls of each K1 / K2 kernel, for a line on
    standard error before the result."""
    parts = [f"{pattern} {rec} of {made}" + (f" (the last {slack} may fall after it)"
                                             if slack else "")
             for pattern, (rec, made, slack) in coverage(obs).items()]
    return "| trace: calls recorded of made: " + "; ".join(parts)


def stretch(obs: dict, key: str):
    """(forwards or steps, seconds) that MFU reads: those dispatched in the
    traced stretch and its length where the run was traced (the profiler's
    stop holds the host for seconds of the window, in which nothing is
    dispatched), the window's otherwise."""
    trace = obs.get("trace")
    if trace and trace.get(key) is not None and trace["window_s"] > 0:
        return trace[key], trace["window_s"]
    return obs.get(key), obs["window_s"]


def serve_mfu(obs: dict):
    """Model operations of the real frames forwarded over the seconds they
    were forwarded in, times the bf16 peak."""
    groups, seconds = stretch(obs, "groups")
    if not groups:
        return None
    frames = np.concatenate([g[3] for g in groups])
    return 100.0 * model_flops(obs["config"], frames[frames > 0]) / (seconds * MFU_PEAK)


def kernel_calls(trace: dict, pattern: str):
    """(recorded calls, recorded seconds) of the kernels whose name holds
    ``pattern``."""
    hits = [v for name, v in trace["kernels"].items() if pattern in name]
    return sum(v[0] for v in hits), sum(v[1] for v in hits)


def roofline(trace: dict, parts: list):
    """Percent share of the least time of the recorded calls in their
    recorded time, over one kernel or several. ``parts``: (name pattern of
    the timed kernels, name pattern of the one kernel a call launches once,
    (bytes, flops) of every call made in the traced stretch, peak FLOP/s).
    The recorded calls' work is the made calls' mean work times the
    recorded count (the profiler can lose records)."""
    least = seconds = 0.0
    for timed, counted, calls, peak in parts:
        recorded, _ = kernel_calls(trace, counted)
        _, spent = kernel_calls(trace, timed)
        if not calls or recorded == 0:
            continue
        least += sum(least_seconds(b, f, peak) for b, f in calls) / len(calls) * recorded
        seconds += spent
    return 100.0 * least / seconds if seconds > 0 else None


def serve_attn_roofline(obs: dict):
    """K2's inference forward (``flash_fwd``) in the traced stretch."""
    trace = obs.get("trace")
    if not trace:
        return None
    a = obs["config"]["midi_extractor_args"]
    calls = []
    for _, rows, t_pad, real in trace["groups"]:
        work = attention_work("fwd", rows, t_pad, real, a["attention_heads"],
                              a["attention_heads_dim"], 2)
        calls += [work] * blocks(obs["config"])
    return roofline(trace, [("flash_fwd", "flash_fwd", calls, PEAK_FLOPS["bf16"])])


def train_mfu(obs: dict):
    """Model operations of the real frames trained, forward and backward
    (three times the forward's; no recompute), over the seconds they were
    trained in, times the bf16 peak."""
    steps, seconds = stretch(obs, "steps")
    if not steps:
        return None
    frames = np.concatenate([s[3] for s in steps])
    flops = 3 * model_flops(obs["config"], frames[frames > 0])
    return 100.0 * flops / (seconds * MFU_PEAK)


#: calls a train step makes of each kernel, under remat (the forward's, and
#: the recompute's of every dual-stream layer's two blocks)
def _train_calls(config: dict) -> dict:
    lay = config["midi_extractor_args"]["lay"]
    n = blocks(config)
    return {"fwd_res": n + 2 * lay, "bwd_dkv": n, "bwd_dq": n,
            "dw_fwd": n + 2 * lay + n, "dw_dw": n}


def train_attn_roofline(obs: dict):
    """K2's training kernels (forward with statistics, dk/dv, dq)."""
    trace = obs.get("trace")
    if not trace or not trace.get("steps"):
        return None
    a = obs["config"]["midi_extractor_args"]
    per = _train_calls(obs["config"])
    parts = []
    for kind, pattern in (("fwd_res", "flash_fwd_stats"), ("bwd_dkv", "flash_bwd_dkv"),
                          ("bwd_dq", "flash_bwd_dq")):
        calls = [attention_work(kind, rows, t_pad, real, a["attention_heads"],
                                a["attention_heads_dim"], 2)
                 for _, rows, t_pad, real in trace["steps"] for _ in range(per[kind])]
        parts.append((pattern, pattern, calls, PEAK_FLOPS["bf16"]))
    return roofline(trace, parts)


def train_dwconv_roofline(obs: dict):
    """K1's training kernels: the forward and the input gradient (one
    kernel, taps reversed), the weight gradient (its partial sums and their
    reduction)."""
    trace = obs.get("trace")
    if not trace or not trace.get("steps"):
        return None
    a = obs["config"]["midi_extractor_args"]
    per = _train_calls(obs["config"])
    parts = []
    for kind, pattern, count in (("dw_fwd", "depthwise_fwd", "depthwise_fwd"),
                                 ("dw_dw", "depthwise_dw", "depthwise_dw_partial")):
        calls = [depthwise_work(rows, t_pad, a["dim"], a["kernel_size"], 2)
                 for _, rows, t_pad, _ in trace["steps"] for _ in range(per[kind])]
        parts.append((pattern, count, calls, PEAK_FLOPS["bf16"]))
    return roofline(trace, parts)
