"""Share of the frames trained in the traced stretch that were padding:
1 - real over rows x frames of each ``task: train_step`` (the program's spans)."""
from benchmark.harness.attribution import pad_share


def read(obs):
    return pad_share(obs, "task: train_step")
