"""Kernel B5: the ELL gather-contract and its plain version."""
