"""Kernels B1 and B2: the (max, min) product, batched and single-pair, and
their plain versions."""
