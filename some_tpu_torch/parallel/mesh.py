"""The data-parallel serving mesh: engine replicas over a row of devices.

Counterpart of the serving half of ``some_tpu/parallel/mesh.py``. The JAX
engine serves over a 1-D ``Mesh`` named ``data``: weights replicated, bucket
rows padded to a multiple of the mesh size and sharded over the axis, one
jitted program split by GSPMD. The port keeps one engine replica per device
of a :class:`Mesh` (``inference/base_infer.py``): :func:`pad_rows` pads a
bucket's rows as the JAX engine does, :func:`split_rows` cuts them into the
contiguous equal shards that ``P("data")`` gives each device, and each
replica runs its shard on its own device.

The training half of the JAX module (``shard_batch`` and its shardings)
serves the JAX trainer, which runs one program over every local device. The
port's trainer runs one process a card instead (``parallel/distributed.py``,
with its collectives), so it has no counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from some_tpu_torch.audio.wire import silence_buffer

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """A 1-D row of devices named ``axis_name``. Replica ``i`` serves on
    ``devices[i]`` and takes the ``i``-th shard of every bucket."""

    devices: Tuple[torch.device, ...]
    axis_name: str = DATA_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (``torch.device``s, or what ``torch.device``
    takes; an int is ``cuda:<int>``), every CUDA device of the process when
    None. A CUDA device without an index is ``cuda:0``. All devices must be
    of one type, and each ``cuda:i`` must exist. A device may repeat: a CPU
    mesh always does, and two replicas may share one card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; name the devices (e.g. ['cpu'] * 2)")
        devices = range(torch.cuda.device_count())
    mesh = []
    for d in devices:
        d = torch.device("cuda", d) if isinstance(d, int) else torch.device(d)
        if d.type == "cuda":
            d = torch.device("cuda", d.index or 0)
        mesh.append(d)
    if not mesh:
        raise ValueError("make_mesh: no devices")
    types = {d.type for d in mesh}
    if len(types) != 1:
        raise ValueError(f"make_mesh: devices of one type, got {sorted(types)}")
    if mesh[0].type == "cuda":
        present = torch.cuda.device_count() if torch.cuda.is_available() else 0
        missing = [str(d) for d in mesh if d.index >= present]
        if missing:
            raise RuntimeError(f"make_mesh: {', '.join(missing)} not present "
                               f"({present} CUDA devices)")
    elif mesh[0].type != "cpu":
        raise ValueError(f"make_mesh: devices of type cuda or cpu, got {mesh[0].type}")
    return Mesh(tuple(mesh))


def local_mesh_size(mesh: Optional[Mesh] = None) -> int:
    """This process's devices in ``mesh``: all of them, since a port mesh
    lives in one process. Without a mesh, 1: each training process drives
    one device (``parallel/distributed.py``)."""
    return 1 if mesh is None else mesh.size


def pad_rows(audio: np.ndarray, mask: np.ndarray, n: int, wire: str, n_samples: int):
    """Pad a bucket's wire rows ``[rows, width]`` and mask ``[rows, frames]``
    to a multiple of ``n`` rows: ``silence_buffer`` rows of the bucket's
    ``n_samples`` (frames x hop - 1; a raw zero byte is full scale under
    mulaw8) and all-False mask rows, which decode to no notes."""
    pad = -len(audio) % n
    if not pad:
        return audio, mask
    return (np.concatenate([audio, silence_buffer(wire, pad, n_samples)]),
            np.concatenate([mask, np.zeros((pad, mask.shape[1]), bool)]))


def split_rows(x: np.ndarray, n: int) -> list:
    """``n`` contiguous equal shards of axis 0, in mesh order (the shards
    ``P("data")`` puts on the devices of a 1-D mesh)."""
    if len(x) % n:
        raise ValueError(f"{len(x)} rows do not split into {n} equal shards; pad_rows first")
    return np.split(x, n)
