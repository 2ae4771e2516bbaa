"""K1 training kernels (forward, input and weight gradients): least time of the recorded calls over their time."""
from benchmark.harness.readers import train_dwconv_roofline


def read(obs):
    return train_dwconv_roofline(obs)
