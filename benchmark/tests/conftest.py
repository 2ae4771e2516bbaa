"""Shared set-up of the benchmark's CPU tests: a cell run at a small width.

The cells run on the CPU here (the program's plain kernel versions, no
card): a one-layer model of width 64, three short songs, four clients, a
window of a few seconds. What needs the card is the benchmark itself
(``run.py`` on the chip); no test here needs it.
"""
from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CONFIG = {"midi_extractor_args": {
    "lay": 1, "dim": 64, "use_lay_skip": True, "kernel_size": 31, "conv_drop": 0.1,
    "ffn_latent_drop": 0.1, "ffn_out_drop": 0.1, "attention_drop": 0.1,
    "attention_heads": 2, "attention_heads_dim": 32}}
TINY_MIX = {"songs": 3, "song_median_s": 12.0, "song_min_s": 8.0, "song_max_s": 16.0,
            "clients": 4, "judge_songs": 2, "server": {"max_batch_chunks": 4,
                                                        "max_wait_ms": 25.0,
                                                        "fast_lane": True}}
SEED = 2 ** 31 + 101


def tiny_run(cell: str, seconds: float = 3.0, root=ROOT, mix=None, **kwargs) -> dict:
    from benchmark.run import run_cell

    mix_overrides = dict(TINY_MIX, **(mix or {}))
    return run_cell(cell, SEED, seconds, False, device="cpu", root=root,
                    config_overrides=TINY_CONFIG, mix_overrides=mix_overrides,
                    t_start=time.monotonic(), **kwargs)

