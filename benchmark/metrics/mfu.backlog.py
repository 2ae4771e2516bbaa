"""Model FLOPs of the real frames forwarded over their seconds at the bf16 peak (backlog cells)."""
from benchmark.harness.readers import serve_mfu


def read(obs):
    return serve_mfu(obs)
