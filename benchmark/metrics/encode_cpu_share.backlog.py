"""How much of the dispatcher's bucketing and wire encoding (its spans
``engine: bucket and wire-encode`` inside the traced stretch) its thread
spent on the CPU, in percent of their wall time: the rest it waited, for
the interpreter's lock that the handler threads hold (the program's spans,
with the thread's CPU time)."""
from benchmark.harness.attribution import cpu_share


def read(obs):
    return cpu_share(obs, "engine: bucket and wire-encode", "serve-dispatcher")
