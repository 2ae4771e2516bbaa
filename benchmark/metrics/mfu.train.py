"""Model FLOPs of the real frames trained, forward and backward, over their seconds at the bf16 peak."""
from benchmark.harness.readers import train_mfu


def read(obs):
    return train_mfu(obs)
