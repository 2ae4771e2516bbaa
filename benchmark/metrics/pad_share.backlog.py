"""Share of the frames launched in the traced stretch that were padding:
1 - real over rows x frames of each ``engine: launch`` (the program's spans)."""
from benchmark.harness.attribution import pad_share


def read(obs):
    return pad_share(obs, "engine: launch")
