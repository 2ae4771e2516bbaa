"""RMVPE of the PyTorch port against the JAX package.

Narrow E2E0 (3 levels, 2 blocks, 4 channels, 32 mel bins) on weights from
the JAX init, with randomized BatchNorm statistics, carried across by
``rmvpe_variables_to_state_dict``; a random ``model.pt`` in the upstream
layout through both packages' loaders; the bucketed, batched and decoded
wrapper paths at full width on the CPU. Probabilities are held to atol 5e-5
/ rtol 1e-4, as tests/test_rmvpe.py holds the JAX package to its torch
oracle.
"""
import jax
import numpy as np
import pytest
import torch

from some_tpu.nn import rmvpe as J
from some_tpu_torch.compat.from_jax import rmvpe_variables_to_state_dict
from some_tpu_torch.nn import rmvpe as R

LAYERS, INTERS, BLOCKS, MELS, OUT_CH = 3, 2, 2, 32, 4
GEOMETRY = dict(n_blocks=BLOCKS, en_de_layers=LAYERS, inter_layers=INTERS,
                en_out_channels=OUT_CH)
ATOL, RTOL = 5e-5, 1e-4
SR = 16000


def _randomized_stats(v, seed):
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: (rng.normal(0, 0.3, a.shape) if np.asarray(a).sum() == 0
                   else rng.uniform(0.5, 2.0, a.shape)).astype(np.float32),
        v["batch_stats"])
    return {"params": jax.tree_util.tree_map(np.asarray, v["params"]), "batch_stats": stats}


@pytest.fixture(scope="module")
def narrow():
    """(JAX model, its variables, the port's E2E0 on the same weights)."""
    jax_model = J.E2E0(**GEOMETRY)
    v = jax_model.init(jax.random.PRNGKey(3), np.zeros((1, 32, MELS), np.float32))
    v = _randomized_stats(v, 7)
    port = R.E2E0(n_mels=MELS, **GEOMETRY).eval()
    port.load_state_dict(rmvpe_variables_to_state_dict(
        v, en_de_layers=LAYERS, inter_layers=INTERS, n_blocks=BLOCKS))
    return jax_model, v, port


@pytest.fixture(scope="module")
def full():
    """A random model.pt in the upstream layout, TimbreFilter included, and
    both packages' RMVPE wrappers loaded from it."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/model.pt"
        torch.save({"model": R.random_state_dict(11)}, path)
        yield J.RMVPE(path), R.RMVPE(path, device="cpu")


def _port(model, mel, t_valid=None):
    with torch.no_grad():
        return model(torch.from_numpy(mel), t_valid=t_valid).numpy()


@pytest.mark.parametrize("T", [32, 96])
def test_e2e0_matches_jax(narrow, T):
    jax_model, v, port = narrow
    mel = np.random.default_rng(T).standard_normal((2, T, MELS)).astype(np.float32)
    want = np.asarray(jax_model.apply(v, mel))
    got = _port(port, mel)
    assert got.shape == want.shape == (2, T, 360)
    assert want.std() > 1e-3  # randomized statistics: the output is not flat
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_t_valid_per_row_matches_jax_and_exact_pad(narrow):
    """Rows of their own pad-32 lengths in a longer bucket: each row equals
    its exact-shape forward (the reference's pad-to-32 program) on its real
    frames, in the port and against JAX's masked forward; a scalar t_valid
    is taken for every row."""
    jax_model, v, port = narrow
    rng = np.random.default_rng(1)
    sems = [64, 32, 96]
    bucket = np.zeros((3, 128, MELS), np.float32)
    for r, sem in enumerate(sems):
        bucket[r, :sem] = rng.standard_normal((sem, MELS))
    got = _port(port, bucket, torch.tensor(sems))
    want = np.asarray(jax_model.apply(v, bucket, t_valid=np.asarray(sems, np.int32)))
    for r, sem in enumerate(sems):
        exact = _port(port, bucket[r:r + 1, :sem])[0]
        np.testing.assert_allclose(got[r, :sem], exact, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got[r, :sem], want[r, :sem], atol=ATOL, rtol=RTOL)
    # without the mask the padding leaks into the real frames (BatchNorm
    # maps zero to a constant): the property the mask exists for
    leaky = _port(port, bucket[1:2])[0, :32]
    assert np.abs(leaky - _port(port, bucket[1:2, :32])[0]).max() > 1e-4
    same = _port(port, bucket[:1, :64], 64)
    np.testing.assert_allclose(same[0], got[0, :64], atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="inference-only"):
        port.train()
        try:
            port(torch.from_numpy(bucket), t_valid=64)
        finally:
            port.eval()


def test_model_pt_loads_as_jax_converts(full):
    """The upstream file: the port's load_state_dict path (TimbreFilter
    dropped, strict otherwise) against JAX's convert_rmvpe_state_dict path
    at full width, through mel2hidden (one 512-frame bucket)."""
    jax_rmvpe, port_rmvpe = full
    mel = np.random.default_rng(2).standard_normal((150, 128)).astype(np.float32)
    want = jax_rmvpe.mel2hidden(mel)
    got = port_rmvpe.mel2hidden(mel)
    assert got.shape == want.shape == (1, 150, 360)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    bad = dict(R.random_state_dict(11), **{"unet.extra.weight": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        R.load_rmvpe_state_dict(R.E2E0(), bad)


def test_mel2hidden_bucket_and_batch(full):
    """Bucketed = exact pad-32 shape; mel2hidden_batch (packed rows, per-row
    t_valid) = per-item mel2hidden, for items in different own buckets."""
    _, port_rmvpe = full
    rng = np.random.default_rng(7)
    mels = [rng.standard_normal((n, 128)).astype(np.float32) for n in (73, 150, 530)]
    singles = [port_rmvpe.mel2hidden(m) for m in mels]
    port_rmvpe.bucket = False
    try:
        exact = port_rmvpe.mel2hidden(mels[0])
    finally:
        port_rmvpe.bucket = True
    np.testing.assert_allclose(singles[0], exact, atol=ATOL, rtol=RTOL)
    for s, b in zip(singles, port_rmvpe.mel2hidden_batch(mels)):
        assert b.shape == s.shape
        np.testing.assert_allclose(b, s, atol=ATOL, rtol=RTOL)


def test_f0_batch_matches_jax_and_per_item(full):
    """f0 of sung-sine waves: the port's packed f0_batch against JAX's and
    against its own per-item infer_from_audio. Voicing (max >= 0.03) is held
    exactly except on frames whose maximum lies within 1e-4 of the
    threshold, counted and printed; f0 in cents on frames voiced in both."""
    jax_rmvpe, port_rmvpe = full
    rng = np.random.default_rng(13)
    waves = []
    for seconds, hz in ((0.8, 220.0), (6.0, 330.0)):
        t = np.arange(int(SR * seconds)) / SR
        waves.append((0.4 * np.sin(2 * np.pi * hz * t) + 0.01 * rng.standard_normal(len(t)))
                     .astype(np.float32))
    got = port_rmvpe.f0_batch(waves, SR)
    want = jax_rmvpe.f0_batch(waves, SR)
    singles = [port_rmvpe.infer_from_audio(w, SR) for w in waves]
    near = 0
    for w, g, j, s in zip(waves, got, want, singles):
        assert g.shape == j.shape == s.shape
        np.testing.assert_allclose(g, s, atol=ATOL, rtol=RTOL)
        peak = port_rmvpe.mel2hidden(port_rmvpe.audio_to_mel(w, SR))[0].max(axis=1)
        flip = (g > 0) != (j > 0)
        assert not (flip & (np.abs(peak - 0.03) > 1e-4)).any()
        near += int((np.abs(peak - 0.03) <= 1e-4).sum())
        both = (g > 0) & (j > 0)
        assert both.sum() > 0
        cents = 1200 * np.abs(np.log2(g[both] / j[both]))
        assert cents.max() < 0.01
    print(f"frames within 1e-4 of the voicing threshold: {near}")


def test_get_pitch_grid_matches_jax(full):
    jax_rmvpe, port_rmvpe = full
    sr = 44100
    t = np.arange(sr) / sr
    w = (0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    length = len(w) // 512 + 1
    f0, uv = port_rmvpe.get_pitch(w, sample_rate=sr, hop_size=512, length=length,
                                  interp_uv=True)
    f0_j, uv_j = jax_rmvpe.get_pitch(w, sample_rate=sr, hop_size=512, length=length,
                                     interp_uv=True)
    assert f0.shape == uv.shape == (length,)
    np.testing.assert_array_equal(uv, uv_j)
    np.testing.assert_allclose(f0, f0_j, rtol=1e-5)


def test_decodes_match_jax_bit_for_bit():
    """The argmax window on the device side + the host decode = the full
    local-average decode, edge centers included; both decodes and the
    bucket grid equal JAX's."""
    rng = np.random.default_rng(3)
    hidden = rng.random((1, 50, R.N_CLASS)).astype(np.float32) * 0.5
    hidden[0, 0, 0] = 0.9
    hidden[0, 1, R.N_CLASS - 1] = 0.9
    hidden[0, 7, :] = 0.001
    center, window = R._argmax_window(torch.from_numpy(hidden))
    j_center, j_window = J._argmax_window(hidden)
    np.testing.assert_array_equal(center.numpy(), np.asarray(j_center))
    np.testing.assert_array_equal(window.numpy(), np.asarray(j_window))
    got = R._decode_window(center.numpy(), window.numpy())
    np.testing.assert_array_equal(got, R.local_average_cents(hidden))
    np.testing.assert_array_equal(got, J.local_average_cents(hidden))
    np.testing.assert_array_equal(R.viterbi_cents(hidden), J.viterbi_cents(hidden))
    for sem in range(32, 36000, 32):
        assert R._bucket_frames(sem) == J._bucket_frames(sem)


def test_missing_checkpoint_and_no_card():
    with pytest.raises(FileNotFoundError):
        R.RMVPE.cached(None, device="cpu")
    with pytest.raises(FileNotFoundError):
        R.RMVPE.cached("/nonexistent/model.pt", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            R.RMVPE(None)
