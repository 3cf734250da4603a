"""Checkpoints of the port: the JAX package's on-disk layout (``ckpt``),
written and read without JAX."""
