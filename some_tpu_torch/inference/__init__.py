"""Port of ``some_tpu/inference``."""
