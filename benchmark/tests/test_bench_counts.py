"""The yardstick's arithmetic against hand counts at small shapes."""
from __future__ import annotations

import numpy as np
import pytest

from benchmark.harness import counts as C
from benchmark.harness import readers as R


def test_key_pairs_by_hand():
    # a bucket of 8 frames: rows with 8, 3 and 0 real frames
    # row 0: 8 queries x 8 keys; row 1: 8 queries x 3 real keys; row 2 (all
    # padding): 8 x 8
    assert C.key_pairs(np.array([8, 3, 0]), 8) == 64 + 24 + 64


@pytest.mark.parametrize("kind,bytes_,flops", [
    ("fwd", 4 * 2 * 2 * 4 * 8 * 2 + 2 * 4, 4 * 2 * 8 * (4 * 4 + 4 * 1)),
    ("fwd_res", 4 * 2 * 2 * 4 * 8 * 2 + 2 * 4 + 8 * 2 * 2 * 4, 4 * 2 * 8 * (4 * 4 + 4 * 1)),
    ("bwd_dkv", 6 * 2 * 2 * 4 * 8 * 2 + 12 * 2 * 2 * 4 + 2 * 4, 8 * 2 * 8 * (4 * 4 + 4 * 1)),
    ("bwd_dq", 5 * 2 * 2 * 4 * 8 * 2 + 16 * 2 * 2 * 4 + 2 * 4, 6 * 2 * 8 * (4 * 4 + 4 * 1)),
])
def test_attention_work_by_hand(kind, bytes_, flops):
    # B=2 rows of T=4 (4 and 1 real), H=2 heads of D=8, bf16
    assert C.attention_work(kind, 2, 4, np.array([4, 1]), 2, 8, 2) == (bytes_, flops)


def test_depthwise_work_by_hand():
    # [2, 4, 8] in bf16, 3 taps: x and y once, the taps once; 2 flops a tap
    assert C.depthwise_work(2, 4, 8, 3, 2) == ((2 * 2 * 4 * 8 + 3 * 8) * 2, 2 * 2 * 4 * 8 * 3)


def test_least_time_takes_the_larger_bound():
    assert C.least_seconds(3.35e12, 1.0, 989e12) == pytest.approx(1.0)
    assert C.least_seconds(1.0, 989e12, 989e12) == pytest.approx(1.0)


def test_model_flops_by_hand():
    """One layer of width 4 (heads 1 x 4), 2 mel bins in, 3 bins out, k=3:
    every product counted once a frame, attention over the real keys."""
    cfg = {"units_dim": 2, "midi_num_bins": 3,
           "midi_extractor_args": {"dim": 4, "lay": 1, "kernel_size": 3,
                                   "attention_heads": 1, "attention_heads_dim": 4}}
    d = 4
    block = (2 * 2 * d * 4 * d * 2        # ffn1, ffn2: two products each
             + 2 * (d * d + d * 2 * d + d * d)  # q, kv, out
             + 2 * (d * 2 * d + d * d)     # pw1, pw2
             + 2 * 3 * d)                  # depthwise
    per_frame = 4 * block + 2 * 2 * (d * 2 * d) + 2 * 2 * 2 * d + 2 * d * 3 + 2 * d
    frames = np.array([5, 7])
    attention = 4 * 4 * 4 * (25 + 49)  # 4 blocks x 4 H D x real pairs
    assert C.model_flops(cfg, frames) == per_frame * 12 + attention


def test_roofline_scales_work_by_recorded_calls():
    """Two of four calls recorded: their work is half the calls' work, over
    the recorded time; a reader finds nothing without records."""
    trace = {"kernels": {"void flash_fwd_mma_kernel<64>": [2, 2e-3]}}
    calls = [(0.0, 989e12 * 1e-3)] * 4  # 1 ms of operations each
    part = ("flash_fwd", "flash_fwd", calls, 989e12)
    assert R.roofline(trace, [part]) == pytest.approx(100.0)
    assert R.roofline({"kernels": {}}, [part]) is None
    assert R.roofline(trace, [part[:2] + ([], 989e12)]) is None


def test_roofline_over_two_kernels_of_one_call():
    """A call that launches two kernels (K1's weight gradient: partial sums,
    then their reduction) is counted by the first and timed by both."""
    trace = {"kernels": {"depthwise_dw_partial_kernel": [3, 2e-3],
                         "depthwise_dw_reduce_kernel": [3, 1e-3]}}
    calls = [(3.35e12 * 1e-3, 0.0)] * 3  # 1 ms of bytes each
    part = ("depthwise_dw", "depthwise_dw_partial", calls, 989e12)
    assert R.roofline(trace, [part]) == pytest.approx(100.0)


def test_idle_share_from_the_trace():
    assert R.idle_share({"trace": {"window_s": 4.0, "busy_s": 1.0}}) == pytest.approx(75.0)
    assert R.idle_share({"trace": None}) is None


CFG = {"midi_extractor_args": {"lay": 2}}  # 6 blocks a forward


def served(flash, depthwise, starts=(1.0, 1.0, 2.0)):
    return {"config": CFG, "trace": {
        "window_s": 4.0, "busy_s": 1.0, "groups": [(s, 1, 64, [64]) for s in starts],
        "kernels": {"flash_fwd_mma_kernel<64>": [flash, 1e-3],
                    "depthwise_fwd_kernel": [depthwise, 1e-3]}}}


def test_coverage_counts_calls_made_by_forward():
    """Three forwards of 6 blocks: 18 calls of each kernel made, the last
    dispatch's 6 possibly after the stretch."""
    assert R.coverage(served(17, 18)) == {"flash_fwd": (17, 18, 6),
                                          "depthwise_fwd": (18, 18, 6)}
    assert "flash_fwd 17 of 18" in R.coverage_line(served(17, 18))


@pytest.mark.parametrize("flash, depthwise, idle", [
    (18, 18, 75.0),    # every call recorded
    (14, 18, 75.0),    # the last forward's calls ran after the stretch
    (20, 18, 75.0),    # a forward dispatched before the stretch ran in it
    (11, 18, None),    # records lost: idle time would read too high
    (18, 0, None),
])
def test_idle_share_needs_every_call_recorded(flash, depthwise, idle):
    got = R.idle_share(served(flash, depthwise))
    assert got == (None if idle is None else pytest.approx(idle))


def test_idle_share_of_a_trace_with_no_device_record():
    obs = served(0, 0, starts=())
    obs["trace"]["busy_s"] = 0.0
    assert R.idle_share(obs) is None


def test_train_coverage_has_no_slack():
    trace = {"window_s": 4.0, "busy_s": 3.0, "steps": [(1.0, 8, 128, [128] * 8)] * 2,
             "kernels": {"flash_fwd_stats": [2 * 10, 1e-3], "flash_bwd_dkv": [2 * 6, 1e-3],
                         "flash_bwd_dq": [2 * 6, 1e-3], "depthwise_fwd": [2 * 16, 1e-3],
                         "depthwise_dw_partial": [2 * 6 - 1, 1e-3]}}
    obs = {"config": CFG, "trace": trace}
    assert R.coverage(obs)["depthwise_dw_partial"] == (11, 12, 0)
    assert R.idle_share(obs) is None
    trace["kernels"]["depthwise_dw_partial"][0] = 12
    assert R.idle_share(obs) == pytest.approx(25.0)


def test_mfu_reads_the_traced_stretch():
    """Traced, MFU is the stretch's work over the stretch's seconds, not
    the window's (the profiler's stop holds the host within it)."""
    cfg = {"units_dim": 2, "midi_num_bins": 3,
           "midi_extractor_args": {"lay": 1, "dim": 8, "attention_heads": 2,
                                   "attention_heads_dim": 4, "kernel_size": 3}}
    step = (1.0, 2, 64, np.array([64, 32]))
    flops = 3 * C.model_flops(cfg, np.array([64, 32]))
    untraced = {"config": cfg, "window_s": 10.0, "steps": [step] * 10, "trace": None}
    assert R.train_mfu(untraced) == pytest.approx(100 * 10 * flops / (10.0 * C.MFU_PEAK))
    traced = dict(untraced, trace={"window_s": 2.0, "steps": [step] * 4})
    assert R.train_mfu(traced) == pytest.approx(100 * 4 * flops / (2.0 * C.MFU_PEAK))
    group = (1.0, 2, 64, np.array([64, 32]))
    served = {"config": cfg, "window_s": 10.0, "groups": [group] * 9,
              "trace": {"window_s": 3.0, "groups": [group] * 3}}
    assert R.serve_mfu(served) == pytest.approx(
        100 * 3 * C.model_flops(cfg, np.array([64, 32])) / (3.0 * C.MFU_PEAK))
