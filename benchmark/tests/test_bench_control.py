"""The check's control and faults, at a size a test run holds.

The control is the plain reference in the precision below the
configuration's (float8 e4m3 products below bfloat16, int4 below int8), put
in the program's place on the same sample: it must fail a compared number
that the program passes. The faults break the timed path underneath a
whole run (the chip's look skipped, the CPU's plain kernels in its place),
and the run must come out not correct: an answer altered where it is made
(every note a semitone up, in the engine's assembly), half of the batch
left out (every second chunk of each dispatched batch answered with no
notes; the songs are long enough to be cut into several chunks)."""
from __future__ import annotations

import pytest

from benchmark.harness.faults import half_batch, half_left_out, note_up, state_unchanged
from benchmark.tests.conftest import tiny_run

BACKLOG = ("conformer8-bf16.serve-backlog", "conformer8-int8.serve-backlog")


@pytest.mark.parametrize("cell", BACKLOG)
def test_the_control_fails_what_the_program_passes(cell):
    out = tiny_run(cell, control=True)
    assert out["result"]["correct"]
    limits = {k: c["limit"] for k, c in out["result"]["checks"].items()}
    control = out["readings"]["control"]
    assert any(control[k] > limits[k] for k in ("pitch_off_share", "note_count_dev"))


@pytest.mark.parametrize("fault", [note_up, half_left_out])
@pytest.mark.parametrize("cell", BACKLOG)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    result = tiny_run(cell, fault=fault, mix={"song_min_s": 18.0, "song_max_s": 24.0})["result"]
    assert result["correct"] is False


TRAIN_MIX = {"hours": 0.03, "warm_epochs": 1}


def test_the_train_control_fails_what_the_program_passes():
    """At this width the program's own gaps need not sit under the cell's
    limits (set at the published width on the card); the control's gaps
    exceed the program's, and fail a limit."""
    out = tiny_run("conformer8-bf16.train", mix=TRAIN_MIX, control=True)
    checks = out["result"]["checks"]
    assert checks["steps_not_replayed"]["value"] == 0  # the CPU's checked steps: eager
    program, control = out["readings"]["program"], out["readings"]["control"]
    limits = {k: c["limit"] for k, c in checks.items() if k in program}
    assert limits
    assert all(control[k] > program[k] for k in limits)
    assert any(control[k] > limits[k] for k in limits)


@pytest.mark.parametrize("fault", [state_unchanged, half_batch])
def test_a_broken_train_step_is_not_correct(fault):
    assert tiny_run("conformer8-bf16.train", mix=TRAIN_MIX, fault=fault)["result"]["correct"] \
        is False
