"""Port of ``some_tpu/ops``."""
import functools


@functools.cache
def custom_ops():
    """``torch.ops.some_tpu``, with the kernels' ops of ``ops/library.py``
    registered: imported on the first call, since that module imports the
    kernel wrappers that call this."""
    import torch

    from some_tpu_torch.ops import library  # noqa: F401  (registers the ops)

    return torch.ops.some_tpu
