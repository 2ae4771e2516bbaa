"""Random-access binarized dataset store (HDF5).

Counterpart of ``some_tpu/data/indexed_dataset.py``, the same file format:
``{prefix}.data`` is an HDF5 file with one group per item index and one
dataset per attribute, beside a numpy ``{prefix}.lengths`` of frame counts.
The files are written and read by the port's own HDF5 codec
(``data/hdf5.py``, numpy only), so no h5py is needed: the JAX package's
h5py reads the port's files, and the port reads the JAX package's.
"""
from __future__ import annotations

import pathlib
from typing import Dict, List, Optional, Sequence

import numpy as np

from some_tpu_torch.data.hdf5 import Hdf5Reader, Hdf5Writer


class IndexedDataset:
    """Lazy-opening reader; items come back as dicts of numpy arrays (a 0-d
    field as a Python scalar), fields in name order, as h5py's groups give
    them. The file is opened on first use, in the process that uses it, and
    its item index is read then, once."""

    def __init__(self, path: pathlib.Path | str, prefix: str):
        self.path = pathlib.Path(path) / f"{prefix}.data"
        if not self.path.exists():
            raise FileNotFoundError(f"IndexedDataset not found: {self.path}")
        self._file = None

    def _ensure_open(self) -> Hdf5Reader:
        if self._file is None:
            self._file = Hdf5Reader(self.path)
        return self._file

    def __len__(self) -> int:
        return len(self._ensure_open().items)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        f = self._ensure_open()
        if index < 0 or index >= len(f.items):
            raise IndexError(f"index {index} out of range")
        out = {}
        for key, info in f.fields(str(index)).items():
            value = f.read(info)
            out[key] = value.item() if value.shape == () else value
        return out

    def attr_length(self, index: int, key: str) -> int:
        """The leading-axis length of one field of an item, from its shape
        alone (no data read): the per-step common shapes of several
        processes."""
        shape = self._ensure_open().fields(str(index))[key].shape
        return int(shape[0]) if shape else 0

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class IndexedDatasetWriter:
    """Sequential writer; call finalize() (or use as a context manager)."""

    def __init__(self, path: pathlib.Path | str, prefix: str,
                 allowed_attrs: Optional[Sequence[str]] = None):
        pathlib.Path(path).mkdir(parents=True, exist_ok=True)
        self.path = pathlib.Path(path) / f"{prefix}.data"
        self.allowed_attrs = set(allowed_attrs) if allowed_attrs is not None else None
        self._file = Hdf5Writer(self.path)
        self._count = 0

    def add_item(self, item: Dict[str, np.ndarray]) -> int:
        idx = self._count
        self._count += 1
        self._file.add_group(str(idx), {
            key: value for key, value in item.items()
            if value is not None and (self.allowed_attrs is None or key in self.allowed_attrs)})
        return idx

    def finalize(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finalize()


def save_lengths(path: pathlib.Path | str, prefix: str, lengths: List[int]) -> None:
    with open(pathlib.Path(path) / f"{prefix}.lengths", "wb") as f:
        np.save(f, lengths)


def load_lengths(path: pathlib.Path | str, prefix: str) -> np.ndarray:
    return np.load(pathlib.Path(path) / f"{prefix}.lengths")
