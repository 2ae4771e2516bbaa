"""Random-access binarized dataset store (HDF5).

Counterpart of ``some_tpu/data/indexed_dataset.py``, the same file format:
``{prefix}.data`` is an HDF5 file with one group per item index and one
dataset per attribute, beside a numpy ``{prefix}.lengths`` of frame counts.
``h5py`` is imported when a file is first opened or written, so importing
this module needs none (the card's machine has no h5py).
"""
from __future__ import annotations

import pathlib
from typing import Dict, List, Optional, Sequence

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as exc:
        raise RuntimeError("h5py is required to read or write indexed datasets") from exc
    return h5py


class IndexedDataset:
    """Lazy-opening reader; items come back as dicts of numpy arrays."""

    def __init__(self, path: pathlib.Path | str, prefix: str):
        self.path = pathlib.Path(path) / f"{prefix}.data"
        if not self.path.exists():
            raise FileNotFoundError(f"IndexedDataset not found: {self.path}")
        self._file = None

    def _ensure_open(self):
        if self._file is None:
            self._file = _h5py().File(self.path, "r")
        return self._file

    def __len__(self) -> int:
        return len(self._ensure_open())

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        f = self._ensure_open()
        if index < 0 or index >= len(f):
            raise IndexError(f"index {index} out of range")
        group = f[str(index)]
        return {key: (value[()].item() if value.shape == () else np.asarray(value[()]))
                for key, value in group.items()}

    def attr_length(self, index: int, key: str) -> int:
        """The leading-axis length of one field of an item, from the HDF5
        shape alone (no data read): the per-step common shapes of several
        processes."""
        ds = self._ensure_open()[f"{index}/{key}"]
        return int(ds.shape[0]) if ds.shape else 0

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
        h5py = _h5py()
        pathlib.Path(path).mkdir(parents=True, exist_ok=True)
        self.path = pathlib.Path(path) / f"{prefix}.data"
        self.allowed_attrs = set(allowed_attrs) if allowed_attrs is not None else None
        self._file = h5py.File(self.path, "w")
        self._count = 0

    def add_item(self, item: Dict[str, np.ndarray]) -> int:
        idx = self._count
        self._count += 1
        for key, value in item.items():
            if value is None or (self.allowed_attrs is not None
                                 and key not in self.allowed_attrs):
                continue
            self._file.create_dataset(f"{idx}/{key}", data=value)
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
