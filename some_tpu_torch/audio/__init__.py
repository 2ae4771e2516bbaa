"""Port of ``some_tpu/audio``."""
