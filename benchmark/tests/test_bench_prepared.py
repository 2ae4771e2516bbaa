"""``prepared_ahead_share.backlog`` on synthetic observations: the share of
the ``dispatcher: infer`` spans started in the traced stretch whose batch
was prepared ahead, over those that carry ``ahead``; None on a program
whose spans carry no ``ahead`` (one serving thread) or without a stretch."""
from __future__ import annotations

import pytest

from benchmark import run as R
from benchmark.tests.test_bench_spans import obs, sp

NAME = "prepared_ahead_share.backlog"
LAUNCHER = "serve-launcher"


def test_reads_the_infers_started_in_the_stretch():
    spans = [
        sp("dispatcher: infer", 50, 150, (1,), LAUNCHER, ahead=True),  # started before
        sp("dispatcher: infer", 150, 300, (2,), LAUNCHER, ahead=False),
        sp("dispatcher: infer", 300, 420, (3,), LAUNCHER, ahead=True),
        sp("dispatcher: infer", 420, 600, (4,), LAUNCHER, ahead=True),
        sp("dispatcher: infer", 600, 990, (5,), LAUNCHER, ahead=True),
        sp("dispatcher: infer", 990, 1200, (6,), LAUNCHER, ahead=False),  # ends after: counts
        sp("dispatcher: infer", 1200, 1300, (7,), LAUNCHER, ahead=False),  # after
        sp("dispatcher: prepare", 310, 400, (4,), chunks=9),
        sp("engine: launch", 160, 200, rows=8, frames=128, real_frames=500),
    ]
    assert R.read_metric(NAME, obs(spans)) == pytest.approx(100.0 * 3 / 5)


def test_infers_without_the_attribute_are_left_out():
    spans = [sp("dispatcher: infer", 200, 300, (1,), LAUNCHER, ahead=False),
             sp("dispatcher: infer", 300, 400, (2,), "serve-dispatcher", chunks=3),
             sp("dispatcher: infer", 400, 500, (3,), LAUNCHER, ahead=True)]
    assert R.read_metric(NAME, obs(spans)) == pytest.approx(50.0)


def test_none_on_a_one_thread_servers_spans_and_without_a_stretch():
    one_thread = [sp("dispatcher: infer", 200 + 100 * i, 290 + 100 * i, (i,), chunks=4)
              for i in range(5)]
    one_thread.append(sp("engine: bucket and wire-encode", 200, 240, (0,)))
    assert R.read_metric(NAME, obs(one_thread)) is None
    ahead = [sp("dispatcher: infer", 200, 300, (1,), LAUNCHER, ahead=True)]
    assert R.read_metric(NAME, obs(ahead)) == pytest.approx(100.0)
    assert R.read_metric(NAME, obs(ahead, 400, 900)) is None  # none started in it
    assert R.read_metric(NAME, {"trace": None, "program": {"spans": ahead}}) is None
    assert R.read_metric(NAME, obs([])) is None
