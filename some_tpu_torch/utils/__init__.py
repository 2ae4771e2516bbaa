"""Port of ``some_tpu/utils``."""
