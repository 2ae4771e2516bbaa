"""Dataset binarization driver (host plane).

Port of ``some_tpu/preprocessing/base_binarizer.py`` (reference:
preprocessing/base_binarizer.py:18-209): per-raw-dir metadata loading,
4-stage prefix matching for the train/valid split, the seeded shuffle,
per-item processing with augmentation on the train split, and the HDF5
indexed-dataset + .lengths output layout.

Device work inside ``process_item`` (RMVPE pitch, ContentVec units) runs on
the binarizer's ``device``: the card unless ``"cpu"``. With ``num_workers >
0`` the items go to a pool of spawned processes (never forked: a forked
child of a process that holds a CUDA context cannot use the card), each of
which builds its own binarizer through ``binarizer_class``.
``item_groups`` yields what ``process()`` writes, so a caller can run
everything but the HDF5 write (``bench_binarize.timed_pass(write=False)``).
"""
from __future__ import annotations

import multiprocessing
import pathlib
import random
import traceback
import warnings
from typing import Dict, List

from some_tpu_torch.data.indexed_dataset import IndexedDatasetWriter, save_lengths

# worker-process binarizer, made once per spawned worker by _worker_init
_WORKER_BINARIZER = None


def _worker_init(cls_name: str, config: dict, device) -> None:
    global _WORKER_BINARIZER
    from some_tpu_torch.preprocessing import binarizer_class
    _WORKER_BINARIZER = binarizer_class(cls_name)(config, device=device)


def _worker_run(job):
    name, meta, aug = job
    try:
        return _WORKER_BINARIZER.process_item(name, meta, allow_aug=aug)
    except Exception:  # the pool maps a failed item to None, as the reference's does
        print(f"| worker failed on {name}:\n{traceback.format_exc()}")
        return None


def _progress(iterable, **kwargs):
    """tqdm's progress bar where tqdm imports; the bare iterable elsewhere."""
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, **kwargs)


class BinarizationError(Exception):
    pass


class BaseBinarizer:
    def __init__(self, config: dict, data_attrs=None, device=None):
        self.config = config
        self.device = device
        self.raw_data_dirs = [pathlib.Path(d) for d in config["raw_data_dir"]]
        self.binary_data_dir = pathlib.Path(config["binary_data_dir"])
        self.data_attrs = list(data_attrs or [])
        self.binarization_args = config["binarization_args"]
        self.timestep = config["hop_size"] / config["audio_sample_rate"]
        self.items: Dict[str, dict] = {}
        self.item_names: List[str] | None = None
        self._train_item_names: List[str] | None = None
        self._valid_item_names: List[str] | None = None

    # ---- subclass hooks ----
    def load_meta_data(self, raw_data_dir: pathlib.Path, ds_id: int) -> None:
        raise NotImplementedError

    def process_item(self, item_name: str, meta_data: dict,
                     allow_aug: bool = False) -> List[dict]:
        raise NotImplementedError

    def check_coverage(self) -> None:
        pass

    # ---- split ----
    def split_train_valid_set(self):
        """4-stage prefix matching of test_prefixes against item names
        (reference: base_binarizer.py:59-110)."""
        prefixes = {str(p) for p in self.config["test_prefixes"]}
        valid_names = set()

        remaining = set(prefixes)
        # 1: exact match including speaker id
        for prefix in list(remaining):
            if prefix in self.item_names:
                valid_names.add(prefix)
                remaining.remove(prefix)
        # 2: exact match without speaker id
        for prefix in list(remaining):
            matched = {n for n in self.item_names if n.split(":")[-1] == prefix}
            if matched:
                valid_names |= matched
                remaining.remove(prefix)
        # 3: prefix match with speaker id
        for prefix in list(remaining):
            matched = {n for n in self.item_names if n.startswith(prefix)}
            if matched:
                valid_names |= matched
                remaining.remove(prefix)
        # 4: prefix match without speaker id
        for prefix in list(remaining):
            matched = {n for n in self.item_names
                       if n.split(":")[-1].startswith(prefix)}
            if matched:
                valid_names |= matched
                remaining.remove(prefix)

        if remaining:
            warnings.warn(
                f"These test_prefixes rules match no dataset item: {sorted(remaining)}",
                category=UserWarning)
        valid_names = sorted(valid_names)
        if not valid_names:
            raise BinarizationError("Validation set is empty!")
        train_names = [n for n in self.item_names if n not in set(valid_names)]
        if not train_names:
            raise BinarizationError("Training set is empty!")
        return train_names, valid_names

    @property
    def train_item_names(self):
        return self._train_item_names

    @property
    def valid_item_names(self):
        return self._valid_item_names

    def meta_data_iterator(self, prefix: str):
        names = self.train_item_names if prefix == "train" else self.valid_item_names
        for name in names:
            yield name, self.items[name]

    # ---- main driver ----
    def load(self) -> None:
        """Metadata of every raw directory, the split, the seeded shuffle."""
        for ds_id, data_dir in enumerate(self.raw_data_dirs):
            self.load_meta_data(pathlib.Path(data_dir), ds_id=ds_id)
        self.item_names = sorted(self.items.keys())
        self._train_item_names, self._valid_item_names = self.split_train_valid_set()

        if self.binarization_args.get("shuffle"):
            random.seed(self.config["seed"])
            random.shuffle(self.item_names)

    def process(self) -> None:
        self.load()
        self.binary_data_dir.mkdir(parents=True, exist_ok=True)
        self.check_coverage()

        self.process_dataset("valid")
        self.process_dataset(
            "train",
            num_workers=int(self.binarization_args.get("num_workers", 0)),
            apply_augmentation=True)

    def item_groups(self, prefix: str, num_workers: int = 0,
                    apply_augmentation: bool = False):
        """Yield the group of binarized items (the item, then its augmented
        copies) of each raw item of the split, in order; None for an item a
        worker failed on."""
        args = [(name, meta, apply_augmentation)
                for name, meta in self.meta_data_iterator(prefix)]
        if num_workers > 0:
            cls_name = f"{type(self).__module__}.{type(self).__qualname__}"
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(num_workers, initializer=_worker_init,
                          initargs=(cls_name, self.config, self.device)) as pool:
                yield from _progress(pool.imap(_worker_run, args), total=len(args),
                                     desc=f"binarize:{prefix}")
            return
        # serial path: let the binarizer batch cross-item device work first
        # (RMVPE pitch rides packed forwards instead of one per song)
        prepare = getattr(self, "prepare_items", None)
        if prepare is not None:
            prepare(args)
        for name, meta, aug in _progress(args, desc=f"binarize:{prefix}"):
            try:
                group = self.process_item(name, meta, allow_aug=aug)
            except BinarizationError as exc:
                print(f"| skipped {name}: {exc}")
                continue
            yield group

    def process_dataset(self, prefix: str, num_workers: int = 0,
                        apply_augmentation: bool = False) -> None:
        lengths: List[int] = []
        total_sec = 0.0
        total_raw_sec = 0.0
        writer = IndexedDatasetWriter(self.binary_data_dir, prefix=prefix,
                                      allowed_attrs=self.data_attrs)
        try:
            for item_group in self.item_groups(prefix, num_workers, apply_augmentation):
                for i, item in enumerate(item_group or ()):
                    if item is None:
                        continue
                    writer.add_item(item)
                    lengths.append(item["length"])
                    total_sec += item["seconds"]
                    if i == 0:
                        total_raw_sec += item["seconds"]
        finally:
            writer.finalize()
        save_lengths(self.binary_data_dir, prefix, lengths)

        if apply_augmentation and total_raw_sec > 0:
            print(f"| {prefix} total duration (before augmentation): {total_raw_sec:.2f}s")
            print(f"| {prefix} total duration (after augmentation): "
                  f"{total_sec:.2f}s ({total_sec / total_raw_sec:.2f}x)")
        else:
            print(f"| {prefix} total duration: {total_raw_sec:.2f}s")
