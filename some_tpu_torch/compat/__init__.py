"""Port of ``some_tpu/compat``."""
