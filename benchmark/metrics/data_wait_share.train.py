"""Share of the traced stretch the training loop waited for its next batch
(``trainer: wait for batch``, the program's spans)."""
from benchmark.harness.attribution import covered_share


def read(obs):
    return covered_share(obs, "trainer: wait for batch")
