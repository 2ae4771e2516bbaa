"""Window-wide rates: every reply answered inside the window, over it."""
from __future__ import annotations

import pytest

from benchmark.drivers.serve import window_metrics


def rec(song, due, done, status=200):
    return (song, due, due, done, status)


def test_serve_rtf_counts_every_reply_inside_the_window():
    audio = [10.0, 30.0]
    records = [rec(0, 0.5, 1.5), rec(1, 1.0, 9.0), rec(0, 9.0, 10.5),  # done after the close
               rec(1, 2.0, 3.0, status=500)]
    e2e, answered, attempted, failed = window_metrics(records, audio, 1.0, 10.0)
    assert e2e["serve_rtf"] == pytest.approx((10.0 + 30.0) / 9.0)
    assert len(answered) == 2 and len(attempted) == 4 and len(failed) == 1


def test_a_request_sent_after_the_close_is_not_attempted():
    records = [rec(0, 0.5, 1.5), rec(0, 10.0, 11.0)]
    _, answered, attempted, _ = window_metrics(records, [10.0], 0.0, 10.0)
    assert len(answered) == 1 and len(attempted) == 1
