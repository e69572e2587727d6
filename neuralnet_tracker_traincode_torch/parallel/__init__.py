"""Data parallelism over several GPUs (counterpart of the JAX package's
`parallel/`)."""
