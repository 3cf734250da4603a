"""Kernel B1: the batched (max, min) product and its plain version."""
