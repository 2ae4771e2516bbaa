"""Deterministic frame-budget bucketed batch samplers.

Counterpart of ``some_tpu/data/sampler.py``: the same numpy
``default_rng(seed + epoch)`` draws in the same order, so for a seed and an
epoch the batch lists are identical to the JAX package's. An epoch-seeded
permutation, a sort by coarse frame count, greedy batching under
``max_batch_frames x max_batch_size`` (padded cost), rank-aware round-robin
assignment with leftover duplication, and a batch-count multiple for
gradient accumulation.
"""
from __future__ import annotations

import math
from typing import Callable, List, Sequence

import numpy as np


def batch_by_frame_budget(indices: Sequence[int], num_frames_fn: Callable[[int], int],
                          max_batch_frames: int = 80000, max_batch_size: int = 48
                          ) -> List[List[int]]:
    """Greedy batching: a batch costs ``len(batch) * max_item_frames``."""
    batches: List[List[int]] = []
    batch: List[int] = []
    batch_max_len = 0
    for idx in indices:
        n = int(num_frames_fn(idx))
        if n > max_batch_frames:
            raise ValueError(
                f"item {idx} has {n} frames, exceeding max_batch_frames={max_batch_frames}")
        new_max = max(batch_max_len, n)
        if batch and (len(batch) == max_batch_size
                      or (len(batch) + 1) * new_max > max_batch_frames):
            batches.append(batch)
            batch = []
            new_max = n
        batch.append(idx)
        batch_max_len = new_max
    if batch:
        batches.append(batch)
    return batches


class BucketBatchSampler:
    """Training sampler: one instance per rank, deterministic in (seed, epoch)."""

    def __init__(self, sizes: np.ndarray, max_batch_frames: int, max_batch_size: int,
                 num_replicas: int = 1, rank: int = 0, frame_count_grid: int = 6,
                 required_batch_count_multiple: int = 1, sort_by_similar_size: bool = True,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False):
        self.sizes = np.asarray(sizes)
        self.max_batch_frames = max_batch_frames
        self.max_batch_size = max_batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.frame_count_grid = frame_count_grid
        self.required_batch_count_multiple = required_batch_count_multiple
        self.sort_by_similar_size = sort_by_similar_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def form_all_batches(self) -> List[List[List[int]]]:
        """Every rank's batch list for the current epoch."""
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.shuffle:
            indices = rng.permutation(len(self.sizes))
            if self.sort_by_similar_size:
                grid = self.frame_count_grid
                assert grid > 0
                coarse = (np.round(self.sizes[indices] / grid) * grid)
                coarse = coarse.clip(grid, None).astype(np.int64)
                indices = indices[np.argsort(coarse, kind="mergesort")]
            indices = indices.tolist()
        else:
            indices = list(range(len(self.sizes)))

        batches = batch_by_frame_budget(
            indices, lambda i: self.sizes[i],
            max_batch_frames=self.max_batch_frames, max_batch_size=self.max_batch_size)

        floored_total = (len(batches) // self.num_replicas) * self.num_replicas
        if self.drop_last and len(batches) > floored_total:
            batches = batches[:floored_total]
            leftovers: List[int] = []
        else:
            leftovers = (rng.permutation(len(batches) - floored_total)
                         + floored_total).tolist()

        assignment_matrix = rng.permuted(
            np.arange(floored_total).reshape(-1, self.num_replicas).transpose(), axis=0)

        per_rank: List[List[List[int]]] = []
        multiple = self.required_batch_count_multiple
        for rank in range(self.num_replicas):
            assignment = assignment_matrix[rank].tolist()
            floored_count = len(assignment)
            ceiled_count = floored_count + (1 if leftovers else 0)
            if rank < len(leftovers):
                assignment.append(leftovers[rank])
            elif leftovers:
                assignment.append(assignment[self.epoch % floored_count])
            if multiple > 1 and ceiled_count % multiple != 0:
                ceiled_count = math.ceil(ceiled_count / multiple) * multiple
                for i in range(ceiled_count - len(assignment)):
                    assignment.append(assignment[(i + self.epoch * multiple) % floored_count])
            per_rank.append([list(batches[i]) for i in assignment])
        return per_rank

    def form_batches(self) -> List[List[int]]:
        return self.form_all_batches()[self.rank]

    def __iter__(self):
        return iter(self.form_batches())

    def __len__(self):
        return len(self.form_batches())


class EvalBatchSampler:
    """Validation sampler: the full deterministic batch list."""

    def __init__(self, sizes: np.ndarray, max_batch_frames: int, max_batch_size: int,
                 batch_by_size: bool = False):
        indices = list(range(len(sizes)))
        if batch_by_size:
            self.batches = batch_by_frame_budget(
                indices, lambda i: sizes[i],
                max_batch_frames=max_batch_frames, max_batch_size=max_batch_size)
        else:
            self.batches = [indices[i:i + max_batch_size]
                            for i in range(0, len(indices), max_batch_size)]

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)
