"""Decoders of the PyTorch port against the JAX package, on the same numpy
inputs: integer outputs exactly, floats to 1e-6."""
import numpy as np
import pytest
import torch

from some_tpu.ops import decode as jd
from some_tpu_torch.ops import decode as td


def _bounds(rng, B, T, dyadic: bool):
    if dyadic:
        # multiples of 1/4: every cumsum is exact in f32 whatever the order,
        # and many land exactly on .5, where round() goes half to even
        return (rng.integers(0, 4, (B, T)) * 0.25 * (rng.random((B, T)) < 0.5)).astype(np.float32)
    return ((rng.random((B, T)) < 0.2) * rng.random((B, T))).astype(np.float32)


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("use_diff", [True, False])
def test_bounds_to_alignment(dyadic, use_diff):
    rng = np.random.default_rng(3)
    bounds = _bounds(rng, 4, 97, dyadic)
    if dyadic:
        assert (np.abs(np.cumsum(bounds, 1) % 1 - 0.5) == 0).any()  # .5 edges present
    want = np.asarray(jd.decode_bounds_to_alignment(bounds, use_diff=use_diff))
    got = td.decode_bounds_to_alignment(torch.from_numpy(bounds), use_diff=use_diff)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_gaussian_blurred_probs():
    rng = np.random.default_rng(4)
    probs = rng.random((3, 41, 128), dtype=np.float32)
    probs[0, :5] *= 0.05  # rests
    want_v, want_r = jd.decode_gaussian_blurred_probs(probs, 0, 127, 1.0, 0.1)
    got_v, got_r = td.decode_gaussian_blurred_probs(torch.from_numpy(probs), 0, 127, 1.0, 0.1)
    print(f"parity gaussian values: max|d| {np.abs(got_v.numpy() - np.asarray(want_v)).max():.3g}")
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))


@pytest.mark.parametrize("dyadic", [True, False])
def test_note_sequence(dyadic):
    rng = np.random.default_rng(5)
    B, T = 3, 80
    frame2item = np.array(jd.decode_bounds_to_alignment(_bounds(rng, B, T, dyadic)))
    frame2item[2, 60:] = 0  # padded frames
    values = (rng.random((B, T), dtype=np.float32) * 80 + 30)
    values[0, :10] = 60.5  # .5 ties in the histogram's round()
    masks = (rng.random((B, T)) < 0.8) & (frame2item > 0)
    want = jd.decode_note_sequence(frame2item, values, masks)
    got = td.decode_note_sequence(torch.from_numpy(frame2item), torch.from_numpy(values),
                                  torch.from_numpy(masks))
    print(f"parity note values: max|d| {np.abs(got[0].numpy() - np.asarray(want[0])).max():.3g}")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_golden_fixture():
    """The reference's doctest vectors (reference: utils/infer_utils.py:103-113)."""
    frame2item = np.array([[1, 1, 1, 1, 2, 2, 3, 3, 3, 0, 0, 0, 0, 0],
                           [1, 1, 1, 2, 3, 3, 3, 3, 3, 4, 4, 0, 0, 0]], dtype=np.int32)
    values = np.array([[60, 61, 60.5, 63, 57, 57, 50, 55, 54, 0, 0, 0, 0, 0],
                       [50, 51, 50.5, 53, 47, 47, 40, 45, 44, 38, 38, 0, 0, 0]], np.float32)
    masks = frame2item > 0
    want = jd.decode_note_sequence(frame2item, values, masks)
    got = td.decode_note_sequence(torch.from_numpy(frame2item), torch.from_numpy(values),
                                  torch.from_numpy(masks))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
