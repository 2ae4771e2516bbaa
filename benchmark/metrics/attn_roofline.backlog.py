"""K2 inference forward: least time of its recorded calls over their recorded time."""
from benchmark.harness.readers import serve_attn_roofline


def read(obs):
    return serve_attn_roofline(obs)
