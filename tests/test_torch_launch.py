"""The kernels' launch plumbing that the CPU can reach: each ctypes launch
runs with its tensor's device current (``ops/_build.launch``,
``on_device``), and the launch tables every CUDA library keeps by kernel
variant (``csrc/launch_counts.cuh``), read by ``ops/_build.variant_launches``.

The header is compiled here by g++ against a two-line stand-in for
``cuda_runtime.h``: the table's macro is plain C++, its only CUDA name the
error type. On the card the kernels' own tables are read by
tests/test_torch_kernels_gpu.py::test_forward_kernels_route_by_dtype.
"""
import contextlib
import ctypes
import shutil
import subprocess

import pytest
import torch

from some_tpu_torch.ops import _build

STUB = "typedef int cudaError_t;\nstatic const cudaError_t cudaSuccess = 0;\n"
LIBRARY = """#include "launch_counts.cuh"
SOME_LAUNCH_COUNTS(fake, "fake_fwd_kernel", "fake_fwd_mma_kernel", "fake_bwd_kernel")
extern "C" int fake_launch(int variant, int err) { return some_counts::counted(variant, err); }
"""


@pytest.fixture
def fake_library(tmp_path, monkeypatch):
    """A library with a launch table of three variants, loaded as
    ``_build.load`` would load it."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    (tmp_path / "cuda_runtime.h").write_text(STUB)
    (tmp_path / "fake.cpp").write_text(LIBRARY)
    lib = tmp_path / "libfake.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-Werror",
                    f"-I{tmp_path}", f"-I{_build.CSRC}", str(tmp_path / "fake.cpp"), "-o",
                    str(lib)], check=True)
    loaded = ctypes.CDLL(str(lib))
    loaded.fake_launch.argtypes = [ctypes.c_int, ctypes.c_int]
    monkeypatch.setitem(_build._loaded, "fake", loaded)
    return loaded


def test_launch_tables_count_each_variant(fake_library):
    """A launch that returned cudaSuccess counts its variant once; a failed
    one counts nothing and hands its error back; names come in table order,
    and a library not loaded is left out."""
    assert _build.variant_launches(["fake", "depthwise_conv"]) == {
        "fake_fwd_kernel": 0, "fake_fwd_mma_kernel": 0, "fake_bwd_kernel": 0}
    assert [fake_library.fake_launch(v, 0) for v in (1, 1, 2)] == [0, 0, 0]
    assert fake_library.fake_launch(0, 98) == 98
    assert _build.variant_launches(["fake"]) == {
        "fake_fwd_kernel": 0, "fake_fwd_mma_kernel": 2, "fake_bwd_kernel": 1}
    assert list(_build.variant_launches(["fake"])) == [
        "fake_fwd_kernel", "fake_fwd_mma_kernel", "fake_bwd_kernel"]
    assert fake_library.some_fake_variant_launches(3) == -1


@pytest.mark.parametrize("current, device", [(0, 0), (0, 1), (1, 0)])
def test_a_launch_runs_under_its_tensors_device(monkeypatch, current, device):
    """``launch`` and ``on_device`` make the tensor's device current around
    the C call and only when another device is current (one card pays no
    switch); the device current before comes back after."""
    state = {"current": current, "switches": []}

    @contextlib.contextmanager
    def switch(index):
        state["switches"].append(index)
        before, state["current"] = state["current"], index
        try:
            yield
        finally:
            state["current"] = before

    monkeypatch.setattr(torch.cuda, "current_device", lambda: state["current"])
    monkeypatch.setattr(torch.cuda, "device", switch)
    seen = []
    assert _build.launch(device, lambda *args: seen.append((state["current"], args)) or 7,
                         1, 2) == 7
    with _build.on_device(device):
        seen.append((state["current"], ()))
    assert seen == [(device, (1, 2)), (device, ())]
    assert state["switches"] == ([] if current == device else [device, device])
    assert state["current"] == current
