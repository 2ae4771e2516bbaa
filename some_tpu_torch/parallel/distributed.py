"""Several training processes on ``torch.distributed``.

Counterpart of ``some_tpu/parallel/distributed.py``. The JAX package joins
one ``jax.distributed`` runtime and lets GSPMD compute each step over the
global batch; here each process runs the model on its rows, and the
collectives below make the step the one-process step on the global batch:
the losses' row and frame counts and BatchNorm's masked sums are summed over
the processes, the gradients are summed after the backward, and every
process applies the same update (see ``training/base_task.py``).

Environment, as the JAX package reads it:
  SOME_TPU_COORDINATOR  host:port of process 0 (alias JAX_COORDINATOR_ADDRESS)
  SOME_TPU_NUM_PROCESSES / SOME_TPU_PROCESS_ID  (aliases JAX_NUM_PROCESSES,
  JAX_PROCESS_ID).
Without them, torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK
(``SOME_TPU_MULTIHOST=auto`` asks for those). The backend is NCCL for a CUDA
device and gloo for the CPU; each process drives one device (the JAX
package's local mesh size is 1 here), ``LOCAL_RANK`` or the process id
modulo the card count.
"""
from __future__ import annotations

import logging
import os
from typing import List, Optional

import torch
import torch.distributed as dist

log = logging.getLogger("some_tpu_torch.distributed")

_ENV_ADDR = ("SOME_TPU_COORDINATOR", "JAX_COORDINATOR_ADDRESS")
_ENV_NPROC = ("SOME_TPU_NUM_PROCESSES", "JAX_NUM_PROCESSES")
_ENV_PID = ("SOME_TPU_PROCESS_ID", "JAX_PROCESS_ID")
_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _env(names) -> Optional[str]:
    for name in names:
        value = os.environ.get(name)
        if value is not None:
            return value
    return None


def maybe_initialize(device=None) -> bool:
    """Join the process group the environment describes; call it before
    anything touches the device (the train CLI does). Returns True if this
    call initialized the group; False, changing nothing, when no coordinator
    is set or a group exists already."""
    addr = _env(_ENV_ADDR)
    torchrun = all(name in os.environ for name in _TORCHRUN)
    auto = os.environ.get("SOME_TPU_MULTIHOST", "").lower() == "auto"
    if (addr is None and not torchrun and not auto) or is_active():
        return False
    if addr is not None:
        nproc, pid = _env(_ENV_NPROC), _env(_ENV_PID)
        if nproc is None or pid is None:
            raise RuntimeError("SOME_TPU_COORDINATOR is set but SOME_TPU_NUM_PROCESSES / "
                               "SOME_TPU_PROCESS_ID are not; set all three")
    elif torchrun:
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        nproc, pid = os.environ["WORLD_SIZE"], os.environ["RANK"]
    else:
        raise RuntimeError("SOME_TPU_MULTIHOST=auto reads torchrun's MASTER_ADDR, "
                           "MASTER_PORT, WORLD_SIZE and RANK, and they are not all set")
    from some_tpu_torch.inference.base_infer import resolve_device

    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the NCCL group; pass device='cpu' for gloo")
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else int(pid) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=int(nproc),
                            rank=int(pid))
    log.info("joined process group: process %d/%d over %s", rank(), world_size(), backend)
    return True


def is_active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_active() else 1


def rank() -> int:
    return dist.get_rank() if is_active() else 0


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the processes (``t`` itself in one process);
    no gradient flows through it."""
    if not is_active():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


class _AllSum(torch.autograd.Function):
    """Sum over the processes whose gradient is the sum of the processes'
    gradients: the derivative of the sum of every process's loss."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """:func:`all_sum` that gradients flow through (BatchNorm's sums)."""
    return _AllSum.apply(t) if is_active() else t


def all_sum_grads_(grads: List[torch.Tensor]) -> None:
    """Sum every process's gradients in place, in one collective (the
    parameters, and so their gradients, are all float32)."""
    if not is_active() or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def destroy() -> None:
    """Leave the process group. Release the captured train steps first
    (``BaseTask.release_graphs``; ``Trainer.fit`` does): NCCL's teardown
    waits for the CUDA graphs that captured its collectives."""
    if is_active():
        dist.destroy_process_group()
