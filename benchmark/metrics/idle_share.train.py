"""Share of the traced stretch in which no operation ran on the card (train cell)."""
from benchmark.harness.readers import idle_share


def read(obs):
    return idle_share(obs)
