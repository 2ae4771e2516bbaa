"""Port of ``some_tpu/nn``."""
