"""The share of the server's batches that were prepared (bucketed and
wire-encoded) before the card was free for them, in percent: of the
``dispatcher: infer`` spans started in the traced stretch that carry
``ahead``, those with ``ahead`` true (the program's spans). None where no
span carries it, as in a program with one serving thread."""
from benchmark.harness.attribution import stretch_spans


def read(obs):
    got = stretch_spans(obs)
    if got is None:
        return None
    spans, t0, t1 = got
    ahead = [s["attrs"]["ahead"] for s in spans
             if s["name"] == "dispatcher: infer" and t0 <= s["start"] <= t1
             and "ahead" in s["attrs"]]
    return 100.0 * sum(ahead) / len(ahead) if ahead else None
