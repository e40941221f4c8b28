"""Data of the port: the numpy-only CIFAR readers, synthetic sets,
transforms and sampler (bit for bit the JAX package's), and a prefetching
loader that feeds one rank's device."""
