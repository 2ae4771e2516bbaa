"""The port's note matcher (``some_tpu_torch/utils/note_f1.py``, its pair
tests done by numpy a block of notes at a time) against the JAX package's
double loop (``some_tpu/utils/note_f1.py``): the same matches in the same
order, and the same scores, on random notes with exact onset ties."""
import numpy as np
import pytest

from some_tpu.utils import note_f1 as jax_f1
from some_tpu_torch.utils import note_f1 as port_f1


def _notes(rng, n, grid):
    on = np.sort(rng.uniform(0, 20, n))
    if grid:  # onsets on a 50 ms grid: many pairs at one distance
        on = np.round(on * 20) / 20
    return on, on + rng.uniform(0.05, 0.4, n), np.round(rng.uniform(40, 44, n))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("options", [{}, {"offset_ratio": 0.2}, {"onset_tolerance": 0.1,
                                                                   "pitch_tolerance": 1.0}])
def test_matches_equal_jax(seed, options):
    rng = np.random.default_rng(seed)
    sizes = [(0, 5), (5, 0), (300, 280), (1500, 1400)][seed]
    ref, pred = _notes(rng, sizes[0], seed % 2 == 0), _notes(rng, sizes[1], seed % 2 == 0)
    want = jax_f1.match_notes(ref, pred, **options)
    assert port_f1.match_notes(ref, pred, **options) == want
    assert (vars(port_f1.note_f1(ref, pred, **options))
            == vars(jax_f1.note_f1(ref, pred, **options)))
