"""K2 training kernels (forward with statistics, dk/dv, dq): least time of the recorded calls over their time."""
from benchmark.harness.readers import train_attn_roofline


def read(obs):
    return train_attn_roofline(obs)
