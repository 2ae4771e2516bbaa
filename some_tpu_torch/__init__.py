"""SOME-TPU ported to PyTorch and CUDA on an NVIDIA H100: inference, serving,
training and preprocessing.

The JAX package ``some_tpu`` is the reference this port is held against; the
port imports nothing of it and nothing of JAX. The kernels that ``some_tpu``
writes in Pallas for the TPU are hand-written CUDA C++ for Hopper here
(``csrc/``), each beside a plain PyTorch version that the CPU runs.
"""
