"""Median time a job waited in the dispatcher's queue (``job: queued``),
over the jobs dispatched in the traced stretch (the program's spans)."""
from benchmark.harness.attribution import queue_wait_p50_ms


def read(obs):
    return queue_wait_p50_ms(obs)
