"""Host data plane of the training path: collation, samplers, the HDF5 store."""
