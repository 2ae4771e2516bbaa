"""Port of ``some_tpu/ops``."""
