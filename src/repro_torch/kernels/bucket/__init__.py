"""Kernels B3 and B4: the level-quantized (max, min) product on int8
tensor cores, and their plain versions."""
