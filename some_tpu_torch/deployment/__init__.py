"""Port of ``some_tpu/deployment``: the ``torch.export`` artifact and the ONNX bridge."""
