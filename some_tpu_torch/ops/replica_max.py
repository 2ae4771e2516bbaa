"""The cross-replica max of int8 serving on a mesh (``quantize: int8`` with ``--devices N``).

The JAX package's ``quantize_activation`` takes one ``jnp.max(jnp.abs(xf))``
over the whole activation (``some_tpu/ops/quant.py``); under the JAX engine's
``data`` mesh GSPMD makes that an all-reduce over every shard, padding rows
included. The port's mesh is N engine replicas, each running its shard
(``inference/base_infer.py``), so at every int8 site each replica hands its
shard's ``max|x|`` to :func:`replica_max` and gets back the max over the N
replicas: every replica divides by one scale, JAX's. A forward of the
production model (8 dual-stream layers) has 160 sites: 18 conformer blocks
x 8 (fc1 and fc2 of both macaron FFNs, the shared q/kv quantization,
out_proj, pw1, pw2) and 8 layers x 2 GLU gates.

A :class:`ReplicaGroup` holds the N replicas of one mesh, one
:class:`ReplicaMember` each; the engine gives each replica's int8 modules
its member (``nn.conformer.set_replica_member``). One engine, and every mesh
that is not int8, has no group and makes no exchange.

* **On the card** the exchange is the hand-written kernel of
  ``csrc/replica_max.cu``: a slot table in mapped pinned host memory that
  every card sees, and a sequence counter on each replica's device that the
  kernel advances, so that it can be captured in each replica's CUDA graph.
* **The plain version**, for CPU meshes: the replicas' forwards run in N
  threads (``base_infer``), and each site meets at a ``threading.Barrier``
  whose action takes the max of the N 0-d amax tensors
  (:func:`replica_max_plain`).

Where trouble is likely, and what the engine does about it:

* a replica waits for its peers inside its stream, so two replicas that
  share a stream deadlock: each replica of a CUDA mesh launches on a stream
  of its own (:func:`replica_stream`, made by the kernel's library, never
  one of PyTorch's pool, which hands its streams out round robin);
* anything that runs one replica alone would wait for absent peers and
  leave its counter behind theirs: the engine refuses it, unless it runs
  under :meth:`ReplicaMember.run_alone`, against a group of one with its own
  counter and table. A capture's eager warm-up runs so, one replica at a
  time, and its outputs are thrown away;
* nothing may synchronise the host between one replica's launches and the
  next's (a capture synchronises the card as it starts): a mesh's round
  captures first on every replica, then launches every replica, then
  collects. First-time host work waits for the card too: CUDA loads a
  kernel's module at its first launch in a process (lazy loading), and
  cuBLAS and cuFFT make their handles and plans. So every replica runs
  new work once against a group of one before it meets its peers: a
  bucket's first run on an int8 mesh captures at once, after the capture's
  warm-up (a graph's kernels are loaded when it is instantiated), and under
  eager dispatch a bucket's first run on a replica's stream is warmed up
  so (``base_infer``);
* concurrent rounds would hand the replicas their exchanges in different
  orders: the mesh runs one round at a time;
* a replica's launches queue behind its spinning exchange, and the host
  blocks once too many are queued, before the next replica is launched:
  an eager round on the card runs the replicas' forwards in N threads
  paced site by site (:meth:`ReplicaGroup.run_threads`), and a graph round
  replays each replica's forward as graph segments of 16 sites, segment by
  segment across the replicas (``base_infer._Segments``; a whole forward's
  graph blocked its launch on an H100);
* nothing that synchronises the card may run between the launches of a
  round, a garbage collection's destructors included (:func:`launching`),
  and the slot tables are never freed;
* a missing peer fails the run and never hangs it: the kernel traps past
  ``bound_s`` (:data:`CARD_BOUND_S`), the barrier raises past its timeout.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import threading
from typing import Sequence

import torch

from some_tpu_torch.ops import _build

#: how long the card's kernel waits for its peers at one exchange before it traps
CARD_BOUND_S = 5.0
#: how long a CPU replica waits at a site's barrier before it raises
CPU_BOUND_S = 300.0
_PTR = ctypes.c_void_p
_lib = None


class PeerError(RuntimeError):
    """A CPU replica met no full group at a site: a peer failed, or it ran alone."""


def _library() -> ctypes.CDLL:
    """The built kernel's library with its signatures bound (on first use)."""
    global _lib
    if _lib is None:
        lib = _build.load("replica_max")
        lib.some_replica_max.restype = ctypes.c_int
        lib.some_replica_max.argtypes = [_PTR] * 4 + [ctypes.c_int] * 2 + [ctypes.c_ulonglong,
                                                                          _PTR]
        lib.some_replica_max_table.restype = _PTR
        lib.some_replica_max_table.argtypes = [ctypes.c_int]
        lib.some_replica_max_stream.restype = ctypes.c_int
        lib.some_replica_max_stream.argtypes = [ctypes.POINTER(_PTR)]
        lib.some_replica_max_touch.restype = ctypes.c_int
        lib.some_replica_max_touch.argtypes = [_PTR, ctypes.c_int, ctypes.c_int, _PTR, _PTR]
        _lib = lib
    return _lib


def replica_stream(device: torch.device) -> torch.cuda.ExternalStream:
    """A non-blocking stream of ``device`` made for one replica alone."""
    handle = _PTR()
    _build.check(_build.launch(device.index, _library().some_replica_max_stream,
                               ctypes.byref(handle)), "replica_stream")
    return torch.cuda.ExternalStream(handle.value, device=device)


def replica_max_touch(table: int, replicas: int, rank: int, out: torch.Tensor) -> None:
    """The bare traffic of one exchange, with no wait and no counter, on the
    current stream of ``out``'s device: replica ``rank`` stores to its slot
    of ``table`` (a table of the caller's own, from :func:`slot_table`) and
    loads every slot of ``replicas``, writing the max into ``out`` (0-d
    float32). Its time is the exchange's latency bound; it is not counted."""
    stream = torch.cuda.current_stream(out.device).cuda_stream
    _build.check(_build.launch(out.get_device(), _library().some_replica_max_touch, table,
                               replicas, rank, out.data_ptr(), stream), "replica_max_touch")


def slot_table(words: int) -> int:
    """A zeroed table of ``words`` 64-bit words in mapped, portable pinned
    host memory, seen by every card; never freed (freeing pinned memory
    synchronises the card)."""
    table = _library().some_replica_max_table(words)
    if not table:
        raise RuntimeError("replica_max: cudaHostAlloc of the slot table failed")
    return table


def replica_max_plain(amaxes: Sequence[torch.Tensor]) -> torch.Tensor:
    """The plain version: the max of N 0-d float32 tensors of one device."""
    return torch.stack(list(amaxes)).amax()


def replica_max(amax: torch.Tensor, member: "ReplicaMember") -> torch.Tensor:
    """The max of ``amax`` (0-d float32, ``max|x|`` of this replica's shard)
    over every replica of ``member``'s group, on ``amax``'s device. On a
    CUDA tensor: one launch of the exchange kernel on the current stream,
    counted in ``replica_max.launches``; on a CPU tensor: the group's
    barrier (:func:`replica_max_plain` over the N replicas' threads)."""
    group = member.group
    if amax.dtype != torch.float32 or amax.dim() != 0:
        raise ValueError(f"replica_max takes a 0-d float32 amax, got {amax.dtype} "
                         f"{tuple(amax.shape)}")
    if amax.device != member.device:
        raise ValueError(f"amax on {amax.device}, replica {member.rank} on {member.device}")
    if amax.device.type == "cpu":
        return group._meet(member.rank, amax)
    if amax.device.type != "cuda":
        raise ValueError(f"replica_max runs on cuda or cpu, got {amax.device}")
    amax = amax.contiguous()
    out = torch.empty((), dtype=torch.float32, device=amax.device)
    stream = torch.cuda.current_stream(amax.device).cuda_stream
    err = _build.launch(amax.get_device(), _library().some_replica_max, amax.data_ptr(),
                        out.data_ptr(), member.seq.data_ptr(), group.table, group.size,
                        member.rank, int(group.bound_s * 1e9), stream)
    _build.check(err, "replica_max")
    replica_max.launches += 1
    if group.paced:
        # an eager round: no replica launches past this site before every
        # replica has launched its exchange here (ReplicaGroup.run_threads)
        group._wait(member.rank)
    return out


replica_max.launches = 0


class ReplicaGroup:
    """The N replicas of one serving mesh that exchange ``max|x|`` at every
    int8 site, on ``devices`` (all CUDA, or all CPU), one
    :class:`ReplicaMember` a device in mesh order (``members``)."""

    def __init__(self, devices: Sequence, bound_s: float | None = None):
        devices = [torch.device(d) for d in devices]
        if not devices or len({d.type for d in devices}) != 1:
            raise ValueError(f"a replica group needs devices of one type, got {devices}")
        self.size = len(devices)
        self.on_card = devices[0].type == "cuda"
        self.bound_s = float(bound_s if bound_s is not None
                             else CARD_BOUND_S if self.on_card else CPU_BOUND_S)
        self.table = None
        if self.on_card:
            if self.size > 1:
                # every kernel built now: an nvcc build on the way to one
                # replica's launches would keep a peer waiting past its bound
                _build.build()
            self.table = slot_table(2 * self.size)
        self._deposits = [None] * self.size
        self._result = None
        # the CPU replicas' exchange; on the card, the eager rounds' pacing
        self._barrier = threading.Barrier(self.size, action=None if self.on_card else self._reduce,
                                          timeout=self.bound_s)
        #: set while run_threads paces the card's replicas site by site
        self.paced = False
        self._pool = None
        self.members = tuple(ReplicaMember(self, rank, d) for rank, d in enumerate(devices))

    # ---- the plain exchange (CPU) ----

    def _reduce(self) -> None:
        self._result = replica_max_plain(self._deposits)

    def _meet(self, rank: int, amax: torch.Tensor) -> torch.Tensor:
        self._deposits[rank] = amax
        self._wait(rank)
        return self._result

    def _wait(self, rank: int) -> None:
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            raise PeerError(f"replica_max: replica {rank} of {self.size} met no full group "
                            f"at an int8 site within {self.bound_s} s (a peer failed, or "
                            "the replica ran alone)") from None

    def run_threads(self, fns: Sequence) -> list:
        """Run ``fns`` (one a replica, in mesh order) in N threads and return
        their results: the CPU replicas' forwards, which meet at the sites'
        barrier; on the card, eager forwards, which meet at it after each
        exchange's launch. A failure in one breaks the barrier at once for
        the others; the first error raises, and the barrier is reset for
        the next round.

        Why the card's eager rounds are paced: a replica's launches queue
        behind its spinning exchange, and CUDA takes only so many launches
        ahead of the card before the host's next launch blocks. One
        replica's whole eager forward (thousands of launches) launched
        before the next replica's first would block the host before that
        replica's first exchange, and the card would wait on it for ever.
        Paced, each replica has at most one site's launches queued ahead of
        its peers' exchanges. Unpaced threads do not do: on an H100, 1,000
        launches behind a waiting exchange returned, 2,000 blocked the
        host, and the peer's exchange launched from another thread meanwhile
        did not run (``tools/torch_mesh_probe.py queue eager``). Graph
        replays go segment by segment instead (``base_infer._Segments``)."""
        if len(fns) != self.size:
            raise ValueError(f"{len(fns)} functions for a group of {self.size}")
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            # kept for the group's life: a thread's OpenMP team is made once
            self._pool = ThreadPoolExecutor(max_workers=self.size,
                                            thread_name_prefix="replica")

        def guarded(fn):
            try:
                return fn()
            except BaseException:
                self._barrier.abort()
                raise

        self.paced = self.on_card
        try:
            futures = [self._pool.submit(guarded, fn) for fn in fns]
            errors = [f.exception() for f in futures]
        finally:
            self.paced = False
        if self._barrier.broken:
            self._barrier.reset()
        # a peer's broken barrier is a consequence: raise the error that broke it
        first = next((e for e in errors if e is not None and not isinstance(e, PeerError)),
                     next((e for e in errors if e is not None), None))
        if first is not None:
            raise first
        return [f.result() for f in futures]

    def __del__(self):
        # the slot table stays until the process ends: freeing pinned memory
        # synchronises the card, and a collection may run while a peer waits
        if self._pool is not None:
            self._pool.shutdown(wait=False)


@contextlib.contextmanager
def launching():
    """No cyclic garbage collection while a round's replicas are launched:
    a collected object's destructor may synchronise the card (a CUDA graph
    or pinned memory freed), and so wait for a spinning exchange whose peer
    is not launched yet."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class ReplicaMember:
    """Replica ``rank`` of a :class:`ReplicaGroup` on ``device``: its
    sequence counter on the card (advanced by the kernel), and, made on
    first use, a group of one of its own for :meth:`run_alone`."""

    def __init__(self, group: ReplicaGroup, rank: int, device: torch.device):
        self.group, self.rank, self.device = group, rank, device
        self.seq = (torch.zeros((), dtype=torch.int64, device=device)
                    if group.on_card else None)
        self.alone = False
        self._solo = None
        #: called after each exchange against the group (a capture's segmenting)
        self.on_site = None

    @property
    def exchanges(self) -> bool:
        """Whether a forward of this replica meets its peers: a group of more
        than one, and not run alone."""
        return self.group.size > 1 and not self.alone

    def max(self, amax: torch.Tensor) -> torch.Tensor:
        """``replica_max`` against the group, or against this replica's group
        of one under :meth:`run_alone`."""
        if self.alone:
            if self._solo is None:
                self._solo = ReplicaGroup([self.device], self.group.bound_s).members[0]
            return replica_max(amax, self._solo)
        out = replica_max(amax, self)
        if self.on_site is not None:
            self.on_site()
        return out

    @contextlib.contextmanager
    def run_alone(self):
        """Run this replica's forwards against a group of one, with its own
        counter and slot table: the scale is then its shard's alone, and the
        group's counters stay in step."""
        previous, self.alone = self.alone, True
        try:
            yield self
        finally:
            self.alone = previous
