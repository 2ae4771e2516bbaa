"""Build and load the hand-written CUDA kernels under ``some_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
by ``nvcc`` for Hopper (``sm_90a``) into ``build/<name>-<hash>.so`` at the
repository root, then bound with ``ctypes``. The hash covers the source, the
shared headers ``csrc/*.cuh`` and the flags, so an edited source or header
rebuilds and an unchanged one is reused.
``build()`` starts one ``nvcc`` per source, all at once, and waits for them.

Every C entry point returns ``cudaGetLastError()`` after its launch; callers
go through :func:`check`, which raises on a non-zero code. Nothing here runs
at import time: the CPU tests import every module of the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterable

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("depthwise_conv", "flash_attention", "flash_attention_bwd", "fused_ffn",
           "splash_attention", "splash_attention_bwd")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of some_tpu_torch "
                           "are built on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> pathlib.Path:
    """Where the library built from ``csrc/<name>.cu`` with NVCC_FLAGS lives."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, pathlib.Path]:
    """Compile every named source whose library is missing, in parallel.

    Each compile writes to a temporary name and renames it into place, so
    concurrent processes never load a half-written library. The compiler's
    report (registers, shared memory, spills) is kept beside the library as
    ``.log``. Raises with the compiler's output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    todo = {name: path for name, path in paths.items() if not path.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        path = todo[name]
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            tmp.replace(path)
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def refuse_grad(what: str, *tensors) -> None:
    """Raise if a kernel launch would cut the autograd graph.

    A launch writes into a fresh tensor through ctypes, so its output has no
    ``grad_fn``. Each raw launch calls this first: inside a
    ``torch.autograd.Function`` (whose forward runs with grad disabled) and
    on the no-grad paths it passes; anywhere else a tensor that needs a
    gradient raises instead of silently getting none."""
    import torch

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no backward on this path: route it through its "
                           "autograd.Function")


def check_rows_aligned(what: str, *tensors) -> None:
    """The bf16 kernels on the tensor cores copy rows in 16-byte pieces
    (``cp.async``, or TMA in the fused FFN): every row they copy must start
    on a 16-byte boundary (data pointers and every stride but the last:
    batch, head and time of a [B, H, T, D] tensor, the row of an [N, D]
    one). The model's tensors meet this; there is no fallback to another
    kernel."""
    import torch

    for t in tensors:
        # a bf16 stride of 8 elements is 16 bytes
        if t.dtype is torch.bfloat16 and (t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1])):
            raise ValueError(f"{what}: bf16 rows must be 16-byte aligned (cp.async, TMA), got "
                             f"strides {t.stride()} at address {t.data_ptr():#x}")
