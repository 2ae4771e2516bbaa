"""The port's training data plane against the JAX package's: the samplers
give identical batch lists, ``pad_to_bucket`` identical arrays, and the HDF5
store reads what the JAX writer wrote."""
import numpy as np
import pytest

from some_tpu.data import collate as jax_collate
from some_tpu.data import sampler as jax_sampler
from some_tpu.data.indexed_dataset import IndexedDatasetWriter as JaxWriter
from some_tpu_torch.data import collate, sampler
from some_tpu_torch.data.indexed_dataset import (
    IndexedDataset, IndexedDatasetWriter, load_lengths, save_lengths,
)
from tests.test_training import make_item


@pytest.mark.parametrize("seed", [7, 114514, 2024])
@pytest.mark.parametrize("multiple,replicas", [(1, 1), (2, 1), (3, 4)])
def test_sampler_batch_lists_identical(seed, multiple, replicas):
    sizes = np.random.default_rng(seed).integers(50, 900, 57)
    kwargs = dict(max_batch_frames=2400, max_batch_size=6, num_replicas=replicas,
                  required_batch_count_multiple=multiple, seed=seed)
    for epoch in (0, 1):
        for rank in range(replicas):
            ours = sampler.BucketBatchSampler(sizes, rank=rank, **kwargs)
            theirs = jax_sampler.BucketBatchSampler(sizes, rank=rank, **kwargs)
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert list(ours) == list(theirs)
            assert len(ours) == len(theirs) > 0
    assert (list(sampler.EvalBatchSampler(sizes, 2000, 3))
            == list(jax_sampler.EvalBatchSampler(sizes, 2000, 3)))
    assert (sampler.batch_by_frame_budget(range(57), lambda i: sizes[i], 3000, 5)
            == jax_sampler.batch_by_frame_budget(range(57), lambda i: sizes[i], 3000, 5))


@pytest.mark.parametrize("grid,lengths", [(128, (37, 90, 61)), (32, (37, 90, 61)),
                                          (32, (64, 64, 5)), (16, (3, 33, 20, 9, 48))])
def test_pad_to_bucket_identical(grid, lengths):
    rng = np.random.default_rng(grid)
    items = [make_item(rng, n, 2 + i) for i, n in enumerate(lengths)]
    keys = ("units", "pitch", "note_midi", "note_rest", "note_dur", "unit2note")
    note_keys = ("note_midi", "note_rest", "note_dur", "note_mask")
    outs = []
    for mod in (collate, jax_collate):
        batch = {k: mod.collate_nd([i[k] for i in items]) for k in keys}
        batch["note_mask"] = mod.collate_nd([np.ones(len(i["note_midi"]), bool) for i in items])
        outs.append(mod.pad_to_bucket(batch, length_grid=grid, note_keys=note_keys))
    ours, theirs = outs
    assert ours.keys() == theirs.keys()
    for key in theirs:
        np.testing.assert_array_equal(np.asarray(ours[key]), np.asarray(theirs[key]), err_msg=key)
        assert np.asarray(ours[key]).dtype == np.asarray(theirs[key]).dtype, key
    assert ours["batch_mask"].sum() == len(lengths)
    for n in (0, 1, 5, 128, 129):
        assert collate.bucket_length(n) == jax_collate.bucket_length(n)
        assert collate.bucket_batch_size(n) == jax_collate.bucket_batch_size(n)


def test_indexed_dataset_reads_the_jax_writer(tmp_path):
    rng = np.random.default_rng(3)
    items = [make_item(rng, n, 4) for n in (40, 55)]
    with JaxWriter(tmp_path, "jax") as writer:
        for item in items:
            writer.add_item(item)
    with IndexedDatasetWriter(tmp_path, "port", allowed_attrs=("units", "note_midi")) as writer:
        for item in items:
            writer.add_item(item)
    save_lengths(tmp_path, "port", [i["length"] for i in items])
    ds = IndexedDataset(tmp_path, "jax")
    assert len(ds) == 2
    for i, item in enumerate(items):
        got = ds[i]
        assert got.keys() == item.keys()
        for key in item:
            np.testing.assert_array_equal(got[key], item[key])
    port = IndexedDataset(tmp_path, "port")
    assert sorted(port[1]) == ["note_midi", "units"]
    np.testing.assert_array_equal(load_lengths(tmp_path, "port"), [40, 55])
    with pytest.raises(IndexError):
        port[2]
    with pytest.raises(FileNotFoundError):
        IndexedDataset(tmp_path, "missing")
