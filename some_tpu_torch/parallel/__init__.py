"""Several processes: ``torch.distributed`` under the JAX package's env contract."""
