"""The port's HDF5 codec (``some_tpu_torch/data/hdf5.py``) and the dataset
store on it (``data/indexed_dataset.py``), against h5py and the JAX
package's ``IndexedDataset`` / ``IndexedDatasetWriter``, which use it.

Both directions, item for item (keys, dtypes, shapes, bits), at 1, 9 and
2000 items: one symbol-table node, two, and a B-tree with internal nodes.
Then ``attr_length``, a property test over random items, the files outside
the subset (each raises), and binarize -> train through the CLIs with h5py
blocked.
"""
import pathlib
import struct
import subprocess
import sys

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from some_tpu.data.indexed_dataset import IndexedDataset as JaxDataset
from some_tpu.data.indexed_dataset import IndexedDatasetWriter as JaxWriter
from some_tpu.preprocessing.me_binarizer import MIDIExtractionBinarizer as JaxBinarizer
from some_tpu_torch.data.hdf5 import Hdf5Reader, UnsupportedHDF5
from some_tpu_torch.data.indexed_dataset import (
    IndexedDataset, IndexedDatasetWriter, load_lengths, save_lengths,
)
from test_binarize_e2e import write_raw_dataset
from test_torch_binarize import bin_config

REPO = pathlib.Path(__file__).resolve().parent.parent
DTYPES = (np.bool_, np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16, np.uint32,
          np.uint64, np.float16, np.float32, np.float64)


def binarizer_item(rng, i):
    """An item with every field of a MIDIExtractionBinarizer item (and its
    types: seconds a Python float, length a Python int), plus the quant
    binarizer's integer note_midi on odd items, a 0-d bool and empty fields."""
    length, notes = int(rng.integers(1, 40)), int(rng.integers(0, 6))
    item = {"seconds": length * 512 / 44100, "length": length,
            "units": rng.standard_normal((length, 80)).astype(np.float32),
            "pitch": (rng.random(length) * 60 + 30).astype(np.float32),
            "note_midi": (rng.random(notes) * 60 + 30).astype(np.float32),
            "note_rest": rng.random(notes) < 0.3,
            "note_dur": rng.integers(1, 20, notes).astype(np.int64),
            "unit2note": np.sort(rng.integers(0, max(notes, 1), length)).astype(np.int64),
            "voiced": np.bool_(i % 3 == 0), "empty": np.zeros((0, 80), np.float32)}
    if i % 2:
        item["note_midi"] = rng.integers(0, 128, notes).astype(np.int64)
    return item


def assert_items_equal(got, want):
    """Keys in h5py's order, dtypes, shapes, bits; 0-d fields as Python scalars."""
    assert list(got) == sorted(want)
    for key, value in want.items():
        value = np.asarray(value)
        if value.shape == ():
            same = got[key] == value.item() or (value != value and got[key] != got[key])  # NaN
            assert type(got[key]) is type(value.item()) and same, key
            continue
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        assert got[key].tobytes() == value.tobytes(), key


def write(writer_cls, path, items):
    writer = writer_cls(path, "train")
    for item in items:
        writer.add_item(item)
    writer.finalize()
    save_lengths(path, "train", [item["length"] for item in items])


@pytest.mark.parametrize("n", [1, 9, 2000])
def test_jax_files_read_by_the_port(tmp_path, n):
    """The JAX package's writer (h5py) -> the port's IndexedDataset."""
    rng = np.random.default_rng(n)
    items = [binarizer_item(rng, i) for i in range(n)]
    write(JaxWriter, tmp_path, items)
    got, want = IndexedDataset(tmp_path, "train"), JaxDataset(tmp_path, "train")
    assert len(got) == len(want) == n
    for i, item in enumerate(items):
        assert_items_equal(got[i], item)
        assert got[i].keys() == want[i].keys()
    for i in range(0, n, max(1, n // 50)):
        for key in ("units", "note_dur", "empty", "voiced", "seconds"):
            assert got.attr_length(i, key) == want.attr_length(i, key)
    np.testing.assert_array_equal(load_lengths(tmp_path, "train"),
                                  [item["length"] for item in items])
    with pytest.raises(IndexError):
        got[n]


@pytest.mark.parametrize("n", [1, 9, 2000])
def test_port_files_read_by_jax(tmp_path, n):
    """The port's writer -> the JAX package's IndexedDataset (h5py), and h5py
    sees the item count, the groups' names and a B-tree of depth 2 or more
    at 2000 items."""
    rng = np.random.default_rng(n + 1)
    items = [binarizer_item(rng, i) for i in range(n)]
    write(IndexedDatasetWriter, tmp_path, items)
    want = JaxDataset(tmp_path, "train")
    assert len(want) == n
    for i, item in enumerate(items):
        assert_items_equal(want[i], item)
    with h5py.File(tmp_path / "train.data", "r") as f:
        assert sorted(f, key=int) == [str(i) for i in range(n)]
    raw = (tmp_path / "train.data").read_bytes()
    root_btree, = struct.unpack_from("<Q", raw, 80)
    assert raw[root_btree + 5] == (1 if n == 2000 else 0)  # the root node's level
    got = IndexedDataset(tmp_path, "train")
    for i in range(0, n, max(1, n // 50)):
        assert got.attr_length(i, "units") == want.attr_length(i, "units") == items[i]["length"]


ARRAYS = st.builds(
    lambda dtype, shape, seed: (np.random.default_rng(seed).integers(0, 256, size=int(
        np.prod(shape)) * np.dtype(dtype).itemsize, dtype=np.uint8).view(dtype).reshape(shape)
        if dtype is not np.bool_ else np.random.default_rng(seed).random(shape) < 0.5),
    st.sampled_from(DTYPES), st.lists(st.integers(0, 5), max_size=3).map(tuple),
    st.integers(0, 2 ** 32 - 1))
ITEMS = st.lists(st.dictionaries(st.from_regex(r"[a-z_][a-z0-9_]{0,11}", fullmatch=True),
                                 ARRAYS, max_size=5), min_size=0, max_size=12)


@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(items=ITEMS)
def test_random_items_round_trip_both_ways(tmp_path_factory, items):
    """Random items of every allowed dtype (random bits: NaNs and infinities
    included) and shape, written by one side and read by the other."""
    tmp = tmp_path_factory.mktemp("h5")
    for n, item in enumerate(items):
        item["length"] = n
    write(IndexedDatasetWriter, tmp / "port", items)
    write(JaxWriter, tmp / "jax", items)
    for reader, path in ((JaxDataset, tmp / "port"), (IndexedDataset, tmp / "jax"),
                         (IndexedDataset, tmp / "port")):
        got = reader(path, "train")
        assert len(got) == len(items)
        for i, item in enumerate(items):
            assert_items_equal(got[i], item)


def test_files_outside_the_subset_raise(tmp_path):
    """Chunked, compressed, string, compound and compact datasets, a
    superblock of another version (h5py's latest format) and a file with no
    signature raise UnsupportedHDF5, and the writer refuses a string; nothing
    is misread."""
    cases = {
        "chunked": lambda f: f.create_dataset("0/a", data=np.arange(8.0), chunks=(4,)),
        "gzip": lambda f: f.create_dataset("0/a", data=np.arange(8.0), compression="gzip"),
        "string": lambda f: f.create_dataset("0/a", data=h5py.string_dtype().type("x"),
                                             dtype=h5py.string_dtype()),
        "compound": lambda f: f.create_dataset("0/a", data=np.zeros(2, "i4,f4")),
        "compact": lambda f: f.create_dataset("0/a", data=np.arange(4.0), dcpl=compact_dcpl()),
    }
    for name, make in cases.items():
        path = tmp_path / f"{name}.data"
        with h5py.File(path, "w") as f:
            make(f)
        with pytest.raises(UnsupportedHDF5):
            reader = Hdf5Reader(path)
            reader.read(reader.fields("0")["a"])
    path = tmp_path / "latest.data"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("0/a", data=np.arange(4.0))
    with pytest.raises(UnsupportedHDF5, match="superblock version"):
        Hdf5Reader(path)
    (tmp_path / "not.data").write_bytes(b"\0" * 128)
    with pytest.raises(UnsupportedHDF5, match="signature"):
        Hdf5Reader(tmp_path / "not.data")
    writer = IndexedDatasetWriter(tmp_path, "strings")
    with pytest.raises(UnsupportedHDF5, match="outside the subset"):
        writer.add_item({"name": np.array("x")})


def compact_dcpl():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    return dcpl


def test_no_h5py_in_the_port():
    """No module of some_tpu_torch imports h5py."""
    for path in (REPO / "some_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:2] == ["import", "h5py"] or words[:2] == ["from", "h5py"]
                        or "__import__(\"h5py\")" in line), f"{path}: {line}"


BLOCK_H5PY = """
import runpy, sys
sys.modules["h5py"] = None  # import h5py raises ImportError
if sys.argv[1] == "some_tpu_torch.train":
    from some_tpu_torch.training.me_task import MIDIExtractionTask
    step = MIDIExtractionTask.train_step

    def logged(self, state, batch):
        logs = step(self, state, batch)
        print("total_loss", float(logs["total_loss"]), flush=True)
        return logs

    MIDIExtractionTask.train_step = logged
module = sys.argv.pop(1)
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""


def test_binarize_then_train_without_h5py(tmp_path):
    """``python -m some_tpu_torch.binarize --device cpu`` on
    tests/test_torch_binarize.py's tiny raw set, then ``python -m
    some_tpu_torch.train --device cpu`` for 3 steps on what it wrote, each
    in a process where ``import h5py`` fails: the losses are finite, the
    checkpoint is written, and every item equals the JAX binarizer's (h5py)
    file's, bit for bit."""
    from some_tpu_torch.config import save_yaml
    from test_training import TINY_CONFIG

    raw = tmp_path / "raw"
    raw.mkdir()
    write_raw_dataset(raw, np.random.default_rng(99))
    config = bin_config(raw, tmp_path / "port", binarizer_cls="preprocessing.MIDIExtractionBinarizer")
    save_yaml(config, tmp_path / "bin.yaml")

    def run(*args):
        out = subprocess.run([sys.executable, "-c", BLOCK_H5PY, *args], cwd=REPO,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
        return out.stdout

    run("some_tpu_torch.binarize", "--config", str(tmp_path / "bin.yaml"), "--device", "cpu")
    JaxBinarizer(bin_config(raw, tmp_path / "jax")).process()
    for prefix in ("train", "valid"):
        got, want = IndexedDataset(tmp_path / "port", prefix), JaxDataset(tmp_path / "jax", prefix)
        assert len(got) == len(want) > 0
        for i in range(len(want)):
            assert_items_equal(got[i], want[i])
        np.testing.assert_array_equal(load_lengths(tmp_path / "port", prefix),
                                      load_lengths(tmp_path / "jax", prefix))
    train_config = dict(TINY_CONFIG, binary_data_dir=str(tmp_path / "port"), units_encoder="mel",
                        units_dim=80, task_cls="training.MIDIExtractionTask",
                        pl_trainer_precision="32-true", val_check_interval=100, ds_workers=0)
    save_yaml(train_config, tmp_path / "train.yaml")
    said = run("some_tpu_torch.train", "--config", str(tmp_path / "train.yaml"), "--exp_name", "t",
               "--work_dir", str(tmp_path / "exp"), "--max_steps", "3", "--device", "cpu")
    losses = [float(line.split()[1]) for line in said.splitlines()
              if line.startswith("total_loss ")]
    assert len(losses) >= 3 and np.isfinite(losses).all()
    assert (tmp_path / "exp" / "t" / "model_ckpt_steps_3.ckpt").exists()
